"""Plain MLPerf DLRM-DCNv2 with a dynamic table: the configuration's float32
model, trained in float64 and scored in float32 with TF32 off.

The model (mlcommons/training recommendation_v2/torchrec_dlrm, `dlrm_main.py`
with `--interaction_type=dcn`; TorchRec `DLRM_DCN`): the dense arch, a ReLU
MLP with ReLU after every layer, over the dense features; x0 = [dense arch
output | the S pooled embeddings], flattened, N wide; a low-rank cross net
(TorchRec `LowRankCrossNet`) of `num_cross_layers` layers

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

written here with row vectors, x_l @ V_l @ W_l + b_l, V_l [N, r], W_l
[r, N], b_l [N], r = `dcn_low_rank_dim`, no activation between them; the
over arch, a ReLU MLP with a linear last layer, over the cross net's output
alone; a logit. Loss: binary cross-entropy on the logit, the batch mean.
Multi-hot bags are sum-pooled (TorchRec's `EmbeddingBagCollection`
default), or pooled as the model's `combiner` says.

The table and the optimizers are `dlrm.py`'s: a dictionary of rows,
rowwise AdaGrad on the table and the port's Adam on the tower (the source
trains both with Adagrad; the configuration's `assumed` says why). Ragged
rows are pooled with no atomics (`pool`): the same inputs give the same
bits.

Precision. `train(kind="float32")` runs the steps in float64 from the
float32 weights, rows and inputs: the value that float32 arithmetic rounds
toward, with no rounding of its own for a program to be compared through.
A float32 step of this tower moves its first gradients by up to 1e-4
(ReLU units of the dense arch that flip under rounding), so a float32
reference would add its own such spread to the program's. `kind="tf32"`
runs them in float32 with TF32 matmuls: the control, one step below the
configuration's float32. `score` runs in float32 under `precision`.

Departures from the source: the MLPs start as facebookresearch/dlrm's
`create_mlp` draws them (W ~ N(0, 2 / (in + out)), b ~ N(0, 1 / out)), the
cross net's V and W xavier-normal and b zero (`LowRankCrossNet`), all from
the benchmark's seed and not from torch's default initialisers; the source's
float16/TF32 mixed precision is not used (float32 throughout, as the
configuration states).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .dlrm import adam, bce, init_rows, precision  # noqa: F401 (the module's interface)


def _mlp(d: int, sizes: Sequence[int]) -> Tuple[List[Tuple[int, int]], int]:
    shapes = []
    for h in sizes:
        shapes.append((d, h))
        d = h
    return shapes, d


def widths(model: dict) -> Tuple[List[Tuple[int, int]], int, int, List[Tuple[int, int]]]:
    """(bottom layers' (in, out), the cross net's width N and rank r, top
    layers' (in, out))."""
    bottom, d = _mlp(model["num_dense_features"], model["bottom_mlp"])
    n = d + model["num_sparse_features"] * model["embedding_dim"]
    top, _ = _mlp(n, model["top_mlp"])
    return bottom, n, int(model["dcn_low_rank_dim"]), top


def leaf_specs(model: dict) -> List[Tuple[Tuple[int, ...], float]]:
    """(shape, std) of every leaf in the port's order: the bottom MLP's W
    [in, out] and b a layer, then V [N, r], W [r, N], b [N] a cross layer,
    then the top MLP's; MLPs as `create_mlp`, V and W xavier-normal
    (std sqrt(2 / (N + r))), b zero."""
    bottom, n, r, top = widths(model)

    def mlp(shapes):
        out = []
        for i, o in shapes:
            out += [((i, o), (2.0 / (i + o)) ** 0.5), ((o,), (1.0 / o) ** 0.5)]
        return out

    xavier = (2.0 / (n + r)) ** 0.5
    cross = [((n, r), xavier), ((r, n), xavier), ((n,), 0.0)] * model["num_cross_layers"]
    return mlp(bottom) + cross + mlp(top)


def macs_per_example(model: dict) -> int:
    """Multiply-adds of one example's forward pass: every linear layer and
    the two products of every cross layer (N r each); the cross net's
    elementwise work is not counted."""
    bottom, n, r, top = widths(model)
    return (sum(i * o for i, o in bottom + top)
            + model["num_cross_layers"] * 2 * n * r)


def pool(rows: torch.Tensor, lengths, combiner: str) -> torch.Tensor:
    """Ragged rows [n, D] of the bags in the row-major order of `lengths`
    [B, S] -> pooled [B, S, D]; an empty bag pools to zeros. The bags of one
    length are summed together, their rows gathered [k, length, D] and
    summed over the length: a fixed order and no atomics, so the same rows
    pool to the same bits (`dlrm.pool`'s `index_add_` does not)."""
    lengths = torch.as_tensor(lengths)
    B, S = lengths.shape
    lens = lengths.reshape(-1).to(device=rows.device, dtype=torch.int64)
    start = torch.cumsum(lens, 0) - lens
    out = rows.new_zeros((B * S, rows.shape[1]))
    for n in torch.unique(lens).tolist():
        if n > 0:
            bags = torch.nonzero(lens == n).reshape(-1)
            at = start[bags, None] + torch.arange(n, device=rows.device)
            out = out.index_copy(0, bags, rows[at].sum(dim=1))
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
    nb, nc = len(model["bottom_mlp"]), model["num_cross_layers"]
    x = dense
    for i in range(nb):
        x = torch.relu(x @ leaves[2 * i] + leaves[2 * i + 1])
    x0 = torch.cat([x, emb.reshape(emb.shape[0], -1)], dim=1)
    z = x0
    at = 2 * nb
    for _ in range(nc):
        v, w, b = leaves[at:at + 3]
        z = x0 * ((z @ v) @ w + b) + z
        at += 3
    nt = len(model["top_mlp"])
    for i in range(nt):
        z = z @ leaves[at + 2 * i] + leaves[at + 2 * i + 1]
        if i < nt - 1:
            z = torch.relu(z)
    return z.reshape(-1)


def score(model: dict, leaves, dense: torch.Tensor, emb: torch.Tensor,
          lengths=None) -> torch.Tensor:
    """Probabilities [B]; emb: one-hot rows [B, S, D], or with `lengths`
    [B, S] the bags' ragged rows [n, D]."""
    with torch.no_grad():
        if lengths is not None:
            emb = pool(emb, lengths, model["combiner"])
        return torch.sigmoid(forward(model, leaves, dense, emb))


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
            if b.get("lengths") is None:
                emb = r[idx].view(ids.shape[0], ids.shape[1], dim)
            else:
                emb = pool(r[idx], b["lengths"], model["combiner"])
            dense = torch.as_tensor(b["dense"], device=device).to(dt)
            label = torch.as_tensor(b["label"], device=device).to(dt)
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
    change = [(a - b.to(device=device, dtype=dt)) for a, b in zip(leaves, leaves0)]
    return {"losses": losses, "grad1": grad1, "grad1_table": grad1_rows, "ids1": ids1,
            "change": change, "change_table": rows - rows0, "ids": all_ids}
