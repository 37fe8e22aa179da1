"""Plain BST (Behavior Sequence Transformer) with a dynamic table: the
configuration's float32 model, trained in float64 and scored in float32
with TF32 off.

The model (Chen et al., "Behavior Sequence Transformer for E-commerce
Recommendation in Alibaba", DLP-KDD 2019, arXiv:1905.06874, section 2 and
Table 1). Feature 0 is the target item, feature 1 the user's behaviour
sequence (its bag, read slot by slot), features 2.. other features. The
target's token t is the mean of its bag's rows (a bag of one: the row). The
sequence of T = 1 + L tokens is [t, b_1 .. b_L] plus a learned position
row each, E = [t; b] + P[:T]; padded places are zero rows and are masked as
keys. `transformer_blocks` post-LN encoder blocks follow, each

    A   = softmax(Q K^T / sqrt(d_h) + M) V, per head, Q = E W_q, K = E W_k,
          V = E W_v, the heads' outputs side by side, then A W_o
    S   = LN(E + A W_o)
    F   = LN(S + relu(S W_1 + b_1) W_2 + b_2)

with `attention_heads` heads of d_h = d / heads, M = -1e9 on the keys of
padded places, LN over the row with scale, bias and eps 1e-6. The readout
z = [dense | t | mean of F over the valid places | each other feature's
bag mean] goes through the top MLP (ReLU after every layer but the last)
to one logit. Loss: binary cross-entropy on the logit, the batch mean.

Departures from the source, each stated under `assumed` in the
configuration too:

- a behaviour's token is its item's row; the source concatenates the
  item's and its category's rows;
- positions are learned by index; the source embeds the time gap to the
  target, and the traffic carries no timestamps;
- the FFN is 4d wide with ReLU; the source uses LeakyReLU and gives no
  width;
- the readout is the mean of the encoded tokens over the valid places beside
  the target's row; the source concatenates and flattens them;
- no dropout;
- the target's rows and the behaviours' rows lie in separate feature
  namespaces (id = feature << 44 | value), so one item has two rows;
- the weights start as `leaf_specs` draws them from the benchmark's seed
  (the harness scales N(0, 1) draws by each leaf's std, so LayerNorm's
  scale starts N(0, 1), not at one).

Bags come as ragged rows, bag by bag in the row-major order of their
lengths [B, S]; `layout` puts each bag's rows at its places of a zero
[B, S, L, D] tensor, L the longest bag, by index arithmetic on the lengths.
One-hot batches ([B, S] rows) are bags of one.

The table and the optimizers are `dlrm.py`'s: a dictionary of rows,
rowwise AdaGrad on the table and the port's Adam on the tower. Precision
as `dlrm_dcnv2.py`: `train(kind="float32")` runs the steps in float64 from
the float32 weights, rows and inputs; `kind="tf32"` runs them in float32
with TF32 matmuls, the control one step below the configuration's float32;
`score` runs in float32 under `precision`.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .dlrm import adam, bce, init_rows, precision  # noqa: F401 (the module's interface)

NEG = -1e9
LN_EPS = 1e-6


def _top_in(model: dict) -> int:
    d = model["embedding_dim"]
    return model["num_dense_features"] + d * model["num_sparse_features"]


def _top_shapes(model: dict) -> List[Tuple[int, int]]:
    shapes, d = [], _top_in(model)
    for h in model["top_mlp"]:
        shapes.append((d, h))
        d = h
    return shapes


def leaf_specs(model: dict) -> List[Tuple[Tuple[int, ...], float]]:
    """(shape, std) of every leaf in the port's order (the JAX package's
    flatten order of {"blocks": [...], "pos", "top"}, each block's keys
    sorted: ffn, ln1, ln2, wk, wo, wq, wv): per block the FFN's W_1 [d, 4d],
    b_1, W_2 [4d, d], b_2 (W He-normal, std sqrt(2 / in); b zero), LN 1 and
    2 (scale N(0, 1), bias zero), W_k, W_o, W_q, W_v [d, d] (std sqrt(1 /
    d)); then P [max_seq_len, d] (std 0.02); then the top MLP's W [in, out]
    (He-normal) and b (zero) a layer."""
    d = model["embedding_dim"]
    he = lambda n: (2.0 / n) ** 0.5  # noqa: E731
    block = [((d, 4 * d), he(d)), ((4 * d,), 0.0), ((4 * d, d), he(4 * d)), ((d,), 0.0),
             ((d,), 1.0), ((d,), 0.0), ((d,), 1.0), ((d,), 0.0)]
    block += [((d, d), (1.0 / d) ** 0.5)] * 4
    top = []
    for i, o in _top_shapes(model):
        top += [((i, o), he(i)), ((o,), 0.0)]
    return block * model["transformer_blocks"] + [((model["max_seq_len"], d), 0.02)] + top


def macs_per_example(model: dict) -> int:
    """Multiply-adds of one example's forward pass, over T = max_seq_len
    tokens a block: the four projections (4 T d^2), the attention's two
    products (2 T^2 d), the FFN (2 T d 4d); then the top MLP's layers. The
    softmax, LN and means are not counted."""
    d, t = model["embedding_dim"], model["max_seq_len"]
    block = 4 * t * d * d + 2 * t * t * d + 8 * t * d * d
    return model["transformer_blocks"] * block + sum(i * o for i, o in _top_shapes(model))


def layout(rows: torch.Tensor, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged rows [n, D] of the bags in the row-major order of `lengths`
    [B, S] -> (rows at their places [B, S, L, D], zero past a bag's length;
    valid [B, S, L] bool), L the longest bag."""
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=rows.device)
    b, s = lens.shape
    width = max(int(lens.max()), 1) if lens.numel() else 1
    start = (torch.cumsum(lens.reshape(-1), 0) - lens.reshape(-1)).view(b, s, 1)
    slot = torch.arange(width, device=rows.device)
    valid = slot < lens[..., None]
    at = torch.where(valid, start + slot, 0)
    out = rows.new_zeros((b, s, width, rows.shape[1]))
    out[valid] = rows[at[valid]]
    return out, valid


def _mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of x [..., L, D] over the valid places [..., L]; 0 where none."""
    v = valid.to(x.dtype)
    return (x * v[..., None]).sum(-2) / v.sum(-1).clamp(min=1.0)[..., None]


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def _block(x: torch.Tensor, mask: torch.Tensor, leaves, heads: int) -> torch.Tensor:
    w1, b1, w2, b2, g1, c1, g2, c2, wk, wo, wq, wv = leaves
    b, t, d = x.shape
    dh = d // heads

    def split(y):  # [B, T, d] -> [B, heads, T, dh]
        return y.view(b, t, heads, dh).permute(0, 2, 1, 3)

    q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
    att = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5 + mask[:, None, None, :], dim=-1)
    a = (att @ v).permute(0, 2, 1, 3).reshape(b, t, d)
    s = _ln(x + a @ wo, g1, c1)
    return _ln(s + torch.relu(s @ w1 + b1) @ w2 + b2, g2, c2)


def forward(model: dict, leaves: Sequence[torch.Tensor], dense: torch.Tensor,
            emb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """dense [B, ND], emb [B, S, L, D] rows at their places (zero under
    padding), valid [B, S, L] -> logits [B]."""
    nb, heads = model["transformer_blocks"], model["attention_heads"]
    target = _mean(emb[:, 0], valid[:, 0])
    tokens = torch.cat([target[:, None], emb[:, 1]], dim=1)
    tok_valid = torch.cat([valid[:, 0].any(-1, keepdim=True), valid[:, 1]], dim=1)
    t = tokens.shape[1]
    if t > model["max_seq_len"]:
        raise ValueError(f"{t} tokens for {model['max_seq_len']} positions")
    pos = leaves[12 * nb]
    x = tokens + pos[:t]
    mask = torch.where(tok_valid, 0.0, NEG).to(x.dtype)
    for i in range(nb):
        x = _block(x, mask, leaves[12 * i:12 * (i + 1)], heads)
    z = [dense, target, _mean(x, tok_valid)]
    z += [_mean(emb[:, f], valid[:, f]) for f in range(2, emb.shape[1])]
    z = torch.cat(z, dim=1)
    top = leaves[12 * nb + 1:]
    nt = len(model["top_mlp"])
    for i in range(nt):
        z = z @ top[2 * i] + top[2 * i + 1]
        if i < nt - 1:
            z = torch.relu(z)
    return z.reshape(-1)


def _inputs(rows: torch.Tensor, ids_shape, lengths):
    """(emb [B, S, L, D], valid) of one batch's rows: ragged rows with their
    `lengths`, or one-hot rows of `ids_shape` [B, S] as bags of one."""
    if lengths is None:
        b, s = ids_shape[:2]
        emb = rows.view(b, s, 1, -1)
        return emb, torch.ones((b, s, 1), dtype=torch.bool, device=rows.device)
    return layout(rows, lengths)


def score(model: dict, leaves, dense: torch.Tensor, emb: torch.Tensor,
          lengths=None) -> torch.Tensor:
    """Probabilities [B]; emb: one-hot rows [B, S, D], or with `lengths`
    [B, S] the bags' ragged rows [n, D]."""
    with torch.no_grad():
        if lengths is None:
            rows, shape = emb.reshape(-1, emb.shape[-1]), emb.shape
        else:
            rows, shape = emb, None
        e, valid = _inputs(rows, shape, lengths)
        return torch.sigmoid(forward(model, leaves, dense, e, valid))


def train(model: dict, table: dict, dense_opt: dict, leaves0: Sequence[torch.Tensor],
          batches: Sequence[dict], start_rows: Callable[[np.ndarray], torch.Tensor],
          device, kind: str = "float32") -> dict:
    """Run the batches' steps from `leaves0` and the table's rows as
    `start_rows(ids)` gives them. A batch's `ids` are one-hot [B, S], or with
    `lengths` [B, S] its bags' ragged ids. Returns what `dlrm.train` returns:
    the losses, the first step's gradients (the table's as its rows of that
    step's ids), every leaf's change after the last step and the ids. With
    `kind="float32"` the steps run in float64 (the module's docstring)."""
    opt = table["optimizer"]
    dt = torch.float64 if kind == "float32" else torch.float32
    all_ids = np.unique(np.concatenate([np.asarray(b["ids"]).reshape(-1) for b in batches]))
    rows0 = start_rows(all_ids).to(device=device, dtype=torch.float32).to(dt)
    rows = rows0.clone()
    acc = torch.full((len(all_ids),), float(opt["initial_accumulator"]), device=device,
                     dtype=dt)
    leaves = [x.detach().to(device=device, dtype=dt, copy=True) for x in leaves0]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    losses, grad1, grad1_rows, ids1 = [], None, None, None
    dim = rows.shape[1]
    with precision(kind):
        for t, b in enumerate(batches, start=1):
            ids = np.asarray(b["ids"])
            idx = torch.from_numpy(np.searchsorted(all_ids, ids.reshape(-1))).to(device)
            r = rows.clone().requires_grad_(True)
            lv = [x.clone().requires_grad_(True) for x in leaves]
            emb, valid = _inputs(r[idx], ids.shape, b.get("lengths"))
            dense = torch.as_tensor(b["dense"], device=device).to(dt)
            label = torch.as_tensor(b["label"], device=device).to(dt)
            loss = bce(forward(model, lv, dense, emb, valid), label)
            g_rows, *g = torch.autograd.grad(loss, [r, *lv])
            losses.append(float(loss.detach()))
            if t == 1:
                grad1 = [x.clone() for x in g]
                u = torch.unique(idx)
                grad1_rows, ids1 = g_rows[u].clone(), all_ids[u.cpu().numpy()]
            with torch.no_grad():
                g2 = (g_rows * g_rows).sum(dim=1) / dim
                acc += g2
                rows -= (opt["learning_rate"] * torch.rsqrt(acc + opt["eps"]))[:, None] * g_rows
                adam(leaves, g, m, v, t, dense_opt)
    change = [(a - b.to(device=device, dtype=dt)) for a, b in zip(leaves, leaves0)]
    return {"losses": losses, "grad1": grad1, "grad1_table": grad1_rows, "ids1": ids1,
            "change": change, "change_table": rows - rows0, "ids": all_ids}
