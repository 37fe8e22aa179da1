"""Plain DLRM with a dynamic table, in float32 with TF32 off.

The model (facebookresearch/dlrm, `dlrm_s_pytorch.py` with `--arch-interaction-op
dot`): bottom MLP with ReLU after every layer over the dense features; the
dot products of every pair of the F = sparse + 1 feature vectors (the bottom
output and the embeddings), their upper triangle in the row-major order of
`np.triu_indices(F, 1)` beside the bottom output; top MLP with ReLU after
every layer but the last; a logit. Loss: binary cross-entropy on the logit,
the batch mean. Weights are the JAX layout's leaves (W [in, out], b [out]),
drawn as `leaf_specs` says; `macs_per_example` counts the model's work.

Multi-hot bags come as ragged rows, bag by bag in the row-major order of
[B, S], with their lengths [B, S]; `pool` sums each bag's rows with
`index_add_` (facebookresearch/dlrm's `EmbeddingBag(mode="sum")`), or takes
their mean or sum over the root of the count, as the model's `combiner`
says. No padded [B, S, L, D] tensor is made.

The table, as a dictionary of rows: an id of the vocabulary reads the row
the fill gave it; a first sighting is admitted and starts at the table's
stated initializer, U(-scale, scale) drawn from a murmur3 hash of the id
(`init_rows`); an unknown id read for scoring is a zero row. Sparse
optimizer: rowwise AdaGrad, a += mean(g^2) over the row (a starts at the
initial accumulator), w -= lr * g / sqrt(a + eps). Dense optimizer: Adam
with its bias corrections inside the root, p -= lr * (m c1) / sqrt(v c2 +
eps^2), c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t).

`precision="tf32"` runs the same with TF32 matmuls: the control, one step
below the configuration's float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

SALT_INIT = 0x85EBCA6B
_M = np.uint32


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _M(16))
    h = h * _M(0x85EBCA6B)
    h = h ^ (h >> _M(13))
    h = h * _M(0xC2B2AE35)
    return h ^ (h >> _M(16))


def init_rows(ids: np.ndarray, dim: int, scale: float) -> np.ndarray:
    """[n, dim] f32 rows U(-scale, scale) of a first sighting: lane d takes
    the top 24 bits of fmix32(h + d * 0x9E3779B9), h the id's murmur3 pair
    hash under the init salt."""
    ids = np.asarray(ids, np.int64)
    with np.errstate(over="ignore"):
        hi = ((ids >> 32) & 0xFFFFFFFF).astype(np.uint32)
        lo = (ids & 0xFFFFFFFF).astype(np.uint32)
        h = (lo * _M(0xCC9E2D51)) ^ (hi * _M(0x1B873593)) ^ _M(SALT_INIT)
        h0 = _fmix32(h ^ (_fmix32(hi) >> _M(1)))
        d = np.arange(dim, dtype=np.uint32) * _M(0x9E3779B9)
        bits = _fmix32(h0[:, None] + d[None, :])
    u = (bits >> _M(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return ((u * np.float32(2.0) - np.float32(1.0)) * np.float32(scale)).astype(np.float32)


@contextlib.contextmanager
def precision(kind: str):
    """float32 (TF32 off) or tf32 matmuls for the block."""
    if kind not in ("float32", "tf32"):
        raise ValueError(f"precision {kind!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def layer_shapes(model: dict) -> List[Tuple[int, int]]:
    """(in, out) of every linear layer, bottom MLP first, as the widths of
    `model` give them; the top MLP's input is the bottom output beside the
    upper triangle of the dot interaction of F = sparse + 1 features."""
    shapes, d = [], model["num_dense_features"]
    for h in model["bottom_mlp"]:
        shapes.append((d, h))
        d = h
    f = model["num_sparse_features"] + 1
    d = model["embedding_dim"] + f * (f - 1) // 2
    for h in model["top_mlp"]:
        shapes.append((d, h))
        d = h
    return shapes


def leaf_specs(model: dict) -> List[Tuple[Tuple[int, ...], float]]:
    """(shape, std) of every leaf in the JAX layout's order, which the port's
    `weights.from_jax_params` takes: for each layer of the bottom MLP and
    then of the top MLP, W [in, out] ~ N(0, 2 / (in + out)) and b [out] ~
    N(0, 1 / out), the published model's init (facebookresearch/dlrm,
    `dlrm_s_pytorch.py` `create_mlp`)."""
    out = []
    for i, o in layer_shapes(model):
        out += [((i, o), (2.0 / (i + o)) ** 0.5), ((o,), (1.0 / o) ** 0.5)]
    return out


def macs_per_example(model: dict) -> int:
    """Multiply-adds of one example's forward pass: every linear layer, and
    the dot interaction as the [F, D] x [D, F] product it is computed as
    (F = sparse + 1)."""
    f, d = model["num_sparse_features"] + 1, model["embedding_dim"]
    return sum(i * o for i, o in layer_shapes(model)) + f * f * d


def pool(rows: torch.Tensor, lengths, combiner: str) -> torch.Tensor:
    """Ragged rows [n, D] of the bags in the row-major order of `lengths`
    [B, S] (an array or a tensor) -> pooled [B, S, D]; an empty bag pools
    to zeros."""
    lengths = torch.as_tensor(lengths)
    B, S = lengths.shape
    lens = lengths.reshape(-1).to(device=rows.device, dtype=torch.int64)
    bag = torch.repeat_interleave(torch.arange(B * S, device=rows.device), lens)
    out = torch.zeros((B * S, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out = out.index_add(0, bag, rows)
    cnt = lens.clamp(min=1).to(rows.dtype)[:, None]
    if combiner == "mean":
        out = out / cnt
    elif combiner == "sqrtn":
        out = out / torch.sqrt(cnt)
    elif combiner != "sum":
        raise ValueError(f"combiner {combiner!r}")
    return out.view(B, S, -1)


def forward(model: dict, leaves: Sequence[torch.Tensor], dense: torch.Tensor,
            emb: torch.Tensor) -> torch.Tensor:
    """dense [B, ND], emb [B, S, D] -> logits [B]."""
    nb = len(model["bottom_mlp"])
    x = dense
    for i in range(nb):
        x = torch.relu(x @ leaves[2 * i] + leaves[2 * i + 1])
    feats = torch.cat([x[:, None, :], emb], dim=1)
    f = feats.shape[1]
    inter = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = np.triu_indices(f, k=1)
    z = torch.cat([x, inter[:, torch.from_numpy(iu).to(x.device),
                            torch.from_numpy(ju).to(x.device)]], dim=1)
    nt = len(model["top_mlp"])
    for i in range(nt):
        z = z @ leaves[2 * (nb + i)] + leaves[2 * (nb + i) + 1]
        if i < nt - 1:
            z = torch.relu(z)
    return z.reshape(-1)


def bce(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    z = logits
    return torch.mean(torch.clamp(z, min=0) - z * label + torch.log1p(torch.exp(-z.abs())))


def score(model: dict, leaves, dense: torch.Tensor, emb: torch.Tensor,
          lengths=None) -> torch.Tensor:
    """Probabilities [B]; emb: one-hot rows [B, S, D], or with `lengths`
    [B, S] the bags' ragged rows [n, D]."""
    with torch.no_grad():
        if lengths is not None:
            emb = pool(emb, lengths, model["combiner"])
        return torch.sigmoid(forward(model, leaves, dense, emb))


def adam(leaves: List[torch.Tensor], grads, m, v, t: int, opt: dict) -> None:
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    tf = np.float32(t)
    c1 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** tf))
    c2 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** tf))
    for p, g, m_, v_ in zip(leaves, grads, m, v):
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(lr * (m_ * c1) * torch.rsqrt(v_ * c2 + eps * eps))


def train(model: dict, table: dict, dense_opt: dict, leaves0: Sequence[torch.Tensor],
          batches: Sequence[dict], start_rows: Callable[[np.ndarray], torch.Tensor],
          device, kind: str = "float32") -> dict:
    """Run the batches' steps from `leaves0` and the table's rows as
    `start_rows(ids)` gives them (fill rows, or the init of first
    sightings). A batch's `ids` are one-hot [B, S], or with `lengths` [B, S]
    its bags' ragged ids. Returns the losses, the first step's gradients
    (per leaf, the table's as its rows of that step's ids) and every leaf's
    change after the last step (the table's over every id the steps
    touched), with the ids they belong to."""
    opt = table["optimizer"]
    all_ids = np.unique(np.concatenate([np.asarray(b["ids"]).reshape(-1) for b in batches]))
    rows0 = start_rows(all_ids).to(device=device, dtype=torch.float32)
    rows = rows0.clone()
    acc = torch.full((len(all_ids),), float(opt["initial_accumulator"]), device=device)
    leaves = [x.detach().clone().to(device) for x in leaves0]
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
            if b.get("lengths") is None:
                emb = r[idx].view(ids.shape[0], ids.shape[1], dim)
            else:
                emb = pool(r[idx], b["lengths"], model["combiner"])
            dense = torch.as_tensor(b["dense"], device=device)
            label = torch.as_tensor(b["label"], device=device)
            loss = bce(forward(model, lv, dense, emb), label)
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
    change = [(a - b.to(device)) for a, b in zip(leaves, leaves0)]
    return {"losses": losses, "grad1": grad1, "grad1_table": grad1_rows, "ids1": ids1,
            "change": change, "change_table": rows - rows0, "ids": all_ids}
