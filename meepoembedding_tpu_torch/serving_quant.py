"""Int8-quantized read-only serving tables (port of
`meepoembedding_tpu/serving_quant.py`).

Serving replicas do not train, so the dynamic table's probe planes,
optimizer state and admission sketch are overhead there. A
`QuantizedTable` is the serving form of a checkpoint: the ids sorted, one
int8 code a value with a per-row affine (zero point and scale), and a
lookup by binary search:

    ids     int64 [N]      sorted
    values  int8  [N, dim] q - 128, where v ~ zero + q * scale
    side    int32 [N, 4]   (id low word, id high word, scale bits, zero bits)

`scales` and `zeros` are f32 views of the side plane. A lookup keeps the
ids in int64 end to end: `torch.searchsorted` finds each query's position,
and two gathers (`kernels.row_gather`, K2) read the codes, through the
plane's [N, dim / 4] int32 view, and the side row; the id read back must
equal the query, else the row is zeros, as on the probe-only serve path.

The reference stores its ids with `jnp.asarray`, which holds them in int32
unless JAX's 64-bit mode is on (the JAX package never turns it on): there,
ids that differ only above bit 31 collide. The port keeps int64, so every
id reads its own row.
"""

from __future__ import annotations

import numpy as np
import torch

from meepoembedding_tpu_torch.kernels import row_gather, row_gather_plain
from meepoembedding_tpu_torch.table.layout import resolve_device


def quantize_rows(values: np.ndarray):
    """Per-row affine int8 on the host, the reference's arithmetic: zero =
    row min, scale = row range / 255 (1 for a constant row), code =
    rint((v - zero) / scale) - 128 clipped to int8. The largest error is
    range / 510 a value. -> (codes int8 [N, dim], scales f32 [N], zeros
    f32 [N])."""
    values = np.asarray(values, np.float32)
    vmin = values.min(axis=1) if values.size else np.zeros((0,), np.float32)
    vmax = values.max(axis=1) if values.size else np.zeros((0,), np.float32)
    scales = np.where(vmax > vmin, (vmax - vmin) / 255.0, 1.0).astype(np.float32)
    q = np.clip(np.rint((values - vmin[:, None]) / scales[:, None]) - 128, -128, 127)
    return q.astype(np.int8), scales, vmin.astype(np.float32)


class QuantizedTable:
    """ids [N] int64 (any order), values [N, dim] float -> a read-only int8
    table on `device`."""

    def __init__(self, ids, values, device="cuda"):
        self.device = resolve_device(device)
        ids = np.asarray(ids, np.int64)
        values = np.asarray(values, np.float32)
        self.dim = values.shape[1]
        if self.device.type == "cuda" and self.dim % 4:
            raise ValueError(f"QuantizedTable on the card needs dim % 4 == 0 (its codes are "
                             f"gathered as int32 words), got dim {self.dim}")
        order = np.argsort(ids, kind="stable")
        ids, values = ids[order], values[order]
        q, scales, zeros = quantize_rows(values)
        side = np.empty((len(ids), 4), np.int32)
        side[:, :2] = ids.view(np.int32).reshape(-1, 2)  # little-endian: low word first
        side[:, 2] = scales.view(np.int32)
        side[:, 3] = zeros.view(np.int32)
        self.ids = torch.from_numpy(ids).to(self.device)
        self.values = torch.from_numpy(q).to(self.device)
        self.side = torch.from_numpy(side).to(self.device)

    @property
    def scales(self) -> torch.Tensor:
        return self.side[:, 2].view(torch.float32)

    @property
    def zeros(self) -> torch.Tensor:
        return self.side[:, 3].view(torch.float32)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "QuantizedTable":
        from meepoembedding_tpu_torch import checkpoint

        ids_parts, val_parts = [], []
        for data in checkpoint.iter_rows(path):
            ids_parts.append(data["ids"])
            val_parts.append(data["values"])
        if sum(len(p) for p in ids_parts) == 0:
            dim = int(checkpoint.read_manifest(path)["dim"])
            return cls(np.zeros((0,), np.int64), np.zeros((0, dim), np.float32), device)
        return cls(np.concatenate(ids_parts), np.concatenate(val_parts), device)

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def nbytes(self) -> int:
        """Device bytes of the table: ids, codes and the side plane (whose
        copy of the ids serves the found check)."""
        return sum(t.numel() * t.element_size() for t in (self.ids, self.values, self.side))

    def lookup(self, ids64, train: bool = False) -> torch.Tensor:
        """[n] int64 ids (numpy or tensor) -> [n, dim] f32 dequantized rows on
        the table's device; absent ids read zeros. `train` is accepted for
        the ScoringService interface and must be False: the table is
        read-only."""
        if train:
            raise ValueError("QuantizedTable is read-only: lookup(train=False) only")
        if isinstance(ids64, torch.Tensor):
            query = ids64.to(device=self.device, dtype=torch.int64).reshape(-1)
        else:
            query = torch.from_numpy(np.ascontiguousarray(ids64, np.int64).reshape(-1)
                                     ).to(self.device)
        n_rows = len(self)
        if n_rows == 0:
            return torch.zeros((query.shape[0], self.dim), dtype=torch.float32,
                               device=self.device)
        pos = torch.searchsorted(self.ids, query).clamp_(max=n_rows - 1).to(torch.int32)
        if self.dim % 4:  # the CPU only (the constructor refuses it on the card)
            codes = row_gather_plain(self.values, pos)
        else:
            codes = row_gather(self.values.view(torch.int32), pos).view(torch.int8)
        side = row_gather(self.side, pos)
        found = side[:, :2].contiguous().view(torch.int64).reshape(-1) == query
        scale = side[:, 2:3].view(torch.float32)
        zero = side[:, 3:4].view(torch.float32)
        rows = (codes.to(torch.float32) + 128.0) * scale + zero
        return rows.masked_fill_(~found[:, None], 0.0)
