"""The reference's dense parameters and Adam state, to and from the port's
modules.

The JAX package keeps a model's params as a pytree (dicts, lists, tuples;
DLRM and the group trainers' dot head: {"bottom": [(W, b), ...], "top":
[(W, b), ...]}; the group trainers' wide head: {"mlp": [...]}) with MLP
weights stored [in, out]; its checkpoints store the tree's leaves in
`jax.tree_util` flatten order (dict keys sorted, lists in order, 0-d
leaves such as DeepFM's `b` included). Every model of the port, and the
group heads of `group_train.py`, gives its parameters in that nesting
(`jax_tree()`), so `param_leaves` lists them in the same order.
`from_jax_params` takes the tree or its flat leaves as numpy arrays and
copies them into the module, transposing the `nn.Linear` weights into
[out, in] (every other weight is kept in the reference's layout);
`to_jax_params` is its inverse. The dense Adam state is the pytree
(m, v, t): the moments shaped like the params, in f32, and the step as an
int32 scalar; `to_jax_adam_state` gives its leaves from the port's
(m, v, t).

The reference's row-sharded trainer keeps its table as one stacked shard,
every plane [S, ...] with shard s at index s; `shard_from_stacked` gives
rank r's `TableShard` from those planes (as numpy arrays) and
`stacked_from_shards` the stacked planes of the ranks' shards.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn


def _flatten(params) -> list:
    if isinstance(params, dict):
        return [leaf for k in sorted(params) for leaf in _flatten(params[k])]
    if isinstance(params, (list, tuple)):
        return [leaf for p in params for leaf in _flatten(p)]
    return [params]


def param_leaves(model: nn.Module) -> List[Tuple[nn.Parameter, bool]]:
    """(parameter, transposed) in the reference's flatten order; transposed
    marks an `nn.Linear` weight, which the reference stores [in, out]."""
    linear = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    return [(p, id(p) in linear) for p in _flatten(model.jax_tree())]


def from_jax_params(model: nn.Module, params: Union[dict, Sequence[np.ndarray]]) -> nn.Module:
    """Copy JAX params (a nested pytree or its flat leaf list) into `model`,
    in place; returns the model. Raises on a count or shape mismatch: a model
    geometry that differs from the trained one would score garbage."""
    leaves = [np.asarray(a) for a in _flatten(params)]
    mine = param_leaves(model)
    if len(leaves) != len(mine):
        raise ValueError(f"{len(leaves)} parameter leaves for a {type(model).__name__} "
                         f"with {len(mine)}")
    with torch.no_grad():
        for j, (a, (p, transposed)) in enumerate(zip(leaves, mine)):
            want = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
            if tuple(a.shape) != want:
                raise ValueError(
                    f"leaf {j}: checkpoint shape {a.shape} != model shape {want}; the "
                    "model geometry at restore must match the one trained")
            p.copy_(torch.from_numpy(np.array(a.T if transposed else a)).to(p.dtype))
    return model


def _host(t: torch.Tensor, transposed: bool) -> np.ndarray:
    """A host copy of a tensor, a Linear weight back in [in, out]."""
    a = t.detach().cpu().numpy()
    return (a.T if transposed else a).copy()  # a copy even where a.T is contiguous


def to_jax_params(model: nn.Module) -> list:
    """The model's params as the reference's pytree leaves, in flatten
    order: host copies, which later in-place updates of the model do not
    reach."""
    return [_host(p, t) for p, t in param_leaves(model)]


def to_jax_adam_state(state, model: nn.Module) -> list:
    """The port's dense Adam state (m, v, t) of `model`'s `param_leaves`, as
    the reference's (m, v, t) leaves: the f32 moments of m, then of v, in
    the params' layout, then t as an int32 scalar. Host copies."""
    m, v, t = state
    flags = [tr for _, tr in param_leaves(model)] * 2
    return [_host(x, tr) for x, tr in zip((*m, *v), flags)] + [np.asarray(t, np.int32)]


def from_jax_adam_state(leaves, model: nn.Module, device) -> tuple:
    """The reference's (m, v, t) leaves -> the port's state for `model`'s
    `param_leaves`, on `device`."""
    mine = param_leaves(model)
    k = len(mine)
    if len(leaves) != 2 * k + 1:
        raise ValueError(f"{len(leaves)} opt_state leaves for {k} parameters")

    def moments(part):
        return [torch.from_numpy(np.ascontiguousarray(a.T if tr else a, np.float32))
                .to(device).reshape(p.shape)
                for a, (p, tr) in zip((np.asarray(x) for x in part), mine)]

    return moments(leaves[:k]), moments(leaves[k:2 * k]), int(leaves[2 * k])


# --- table shards: the reference's stacked [S, ...] planes -------------------

_BUCKET_PLANES = ("key_hi", "key_lo", "cnt", "ovf", "freq", "last", "counters", "cms")


def _rows_tensor(a: np.ndarray, rows: int, device) -> torch.Tensor:
    """A reference values-like plane ([vrows, 128] lanes, the same bytes as
    [rows, dim] row-major) as the port's [rows, dim]; a 2-byte float plane
    (ml_dtypes' bfloat16, or its raw uint16 bits) as bfloat16."""
    a = np.ascontiguousarray(a).reshape(rows, -1)
    if a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def shard_from_stacked(stacked: Dict[str, object], rank: int, device="cpu"):
    """Rank `rank`'s TableShard, on `device`, from the reference's stacked
    shard planes: {"key_hi", "key_lo", "cnt", "ovf", "freq", "last",
    "values", "counters", "cms": [S, ...] arrays, "opt_rowwise",
    "opt_fulldim": lists of them}. Values-like planes keep their bits."""
    from meepoembedding_tpu_torch.table.layout import TableShard

    rows = stacked["key_hi"][rank].size  # a slot a bucket lane

    def t(a):
        return torch.from_numpy(np.array(a[rank])).to(device)

    return TableShard(
        values=_rows_tensor(stacked["values"][rank], rows, device),
        opt_rowwise=tuple(t(p) for p in stacked["opt_rowwise"]),
        opt_fulldim=tuple(_rows_tensor(p[rank], rows, device) for p in stacked["opt_fulldim"]),
        **{n: t(stacked[n]) for n in _BUCKET_PLANES})


def _host_plane(x: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as its uint16 bits (numpy has no bfloat16)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).copy()
    return x.numpy().copy()


def stacked_from_shards(shards: Sequence) -> Dict[str, object]:
    """The reference's stacked planes of the ranks' shards (shard s = rank
    s), the inverse of `shard_from_stacked`: values-like planes as [S,
    rows * dim / 128, 128] lanes, bf16 as uint16 bits."""
    def stack(planes):
        return np.stack([_host_plane(p) for p in planes])

    def lanes(planes):
        return stack(planes).reshape(len(planes), -1, 128)

    out = {n: stack([getattr(sh, n) for sh in shards]) for n in _BUCKET_PLANES}
    out["values"] = lanes([sh.values for sh in shards])
    out["opt_rowwise"] = [stack([sh.opt_rowwise[j] for sh in shards])
                          for j in range(len(shards[0].opt_rowwise))]
    out["opt_fulldim"] = [lanes([sh.opt_fulldim[j] for sh in shards])
                          for j in range(len(shards[0].opt_fulldim))]
    return out


# --- column-sharded tables: the reference's [S, C, ...] planes -----------------

def _column(stacked: Dict[str, object], c: int) -> Dict[str, object]:
    return {k: [p[:, c] for p in v] if isinstance(v, list) else v[:, c]
            for k, v in stacked.items()}


def shard_from_stacked2(stacked: Dict[str, object], s: int, c: int, device="cpu"):
    """The TableShard of row shard `s`, column `c`, on `device`, from a
    column-sharded table's planes stacked [S, C, ...] (the reference's
    `addressable_shard_trees2` layout; the keys of `shard_from_stacked`)."""
    return shard_from_stacked(_column(stacked, c), s, device)


def stacked_from_shards2(shards_by_sc: Dict[Tuple[int, int], object], S: int, C: int
                         ) -> Dict[str, object]:
    """The inverse of `shard_from_stacked2`: {(s, c): TableShard} of a
    whole S x C grid -> the reference's [S, C, ...] stacked planes."""
    cols = [stacked_from_shards([shards_by_sc[(s, c)] for s in range(S)]) for c in range(C)]
    return {k: ([np.stack([col[k][j] for col in cols], axis=1) for j in range(len(v))]
                if isinstance(v, list) else np.stack([col[k] for col in cols], axis=1))
            for k, v in cols[0].items()}
