"""Candidate retrieval serving (port of `meepoembedding_tpu/retrieval.py`),
the serving half of the two-tower model (`models/two_tower.py`).

`ItemIndex` is an exact maximum-inner-product index kept on the device:
the top-k over N items is a [Q, E] x [E, C] matmul a chunk of C items
followed by `torch.topk` over the running best k and the chunk, so the
score matrix never grows beyond [Q, k + C]. Products are f32 whatever the
index's dtype (float32 or bfloat16).

`RetrievalService` wraps a `ScoringService` (f32 or int8) whose model is a
two-tower: `build_index` embeds the item corpus through the item tower
once, and `retrieve` runs only the query tower and the index a request.
"""

from __future__ import annotations

import numpy as np
import torch

from meepoembedding_tpu_torch.models.common import DTYPES


def _tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


class ItemIndex:
    """Exact on-device MIPS index over item vectors.

    vectors: [N, E] float (numpy or a tensor). keys: [N] int64 external item
    identifiers that queries return (default 0..N-1). The items are held in
    chunks of `chunk` (at most the corpus rounded up to a power of two, at
    least 8), the last one padded with zero vectors whose bias is -inf.
    """

    def __init__(self, vectors, keys=None, chunk: int = 1 << 15, dtype: str = "float32",
                 device="cuda"):
        self.device = torch.device(device)
        v = _tensor(vectors, self.device, torch.float32)
        if v.dim() != 2:
            raise ValueError(f"vectors must be [N, E], got {tuple(v.shape)}")
        self.num_items, self.dim = v.shape
        self.keys = (np.arange(self.num_items, dtype=np.int64) if keys is None
                     else np.asarray(keys, np.int64))
        if len(self.keys) != self.num_items:
            raise ValueError(f"{len(self.keys)} keys for {self.num_items} items")
        c = min(chunk, 1 << max(3, (self.num_items - 1).bit_length()))
        nc = -(-self.num_items // c)
        pad = nc * c - self.num_items
        if pad:
            v = torch.cat([v, v.new_zeros((pad, self.dim))])
        bias = torch.zeros(nc * c, dtype=torch.float32, device=self.device)
        bias[self.num_items:] = -float("inf")
        self._chunks = v.reshape(nc, c, self.dim).to(DTYPES[dtype])
        self._bias = bias.reshape(nc, c)

    @torch.no_grad()
    def topk(self, queries, k: int):
        """[Q, E] query vectors -> (keys [Q, k] int64, scores [Q, k] f32) as
        numpy arrays, best first. k is clamped to the corpus size."""
        k = min(k, self.num_items)
        q = _tensor(queries, self.device, torch.float32)
        c = self._chunks.shape[1]
        best_s = torch.full((q.shape[0], k), -float("inf"), device=self.device)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=self.device)
        for ci in range(self._chunks.shape[0]):
            s = q @ self._chunks[ci].float().T + self._bias[ci][None, :]
            idx = torch.arange(ci * c, (ci + 1) * c, device=self.device).expand(q.shape[0], c)
            best_s, sel = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
            best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1, sel)
        return self.keys[best_i.cpu().numpy()], best_s.cpu().numpy()


class RetrievalService:
    """Two-tower retrieval over a restored checkpoint: a `ScoringService`
    (restore, probe-only or int8 table) whose model must be a `TwoTower`;
    the item index is built through the item tower, queries run through the
    query tower and the index."""

    def __init__(self, scoring, index_dtype: str = "float32", embed_batch: int = 8192):
        if not hasattr(scoring.model, "embed_item"):
            raise ValueError(f"retrieval needs a two_tower checkpoint; model is "
                             f"{type(scoring.model).__name__}")
        self.scoring = scoring
        self.model = scoring.model
        self.index_dtype = index_dtype
        self.embed_batch = embed_batch
        self.index: ItemIndex | None = None
        self._rows = self._row_keys = None

    @torch.no_grad()
    def build_index(self, item_ids, keys=None) -> ItemIndex:
        """item_ids: [N, IF] int64, each row one candidate item's item-side
        feature ids (IF = num_sparse_features - num_query_features). keys:
        [N] external identifiers (default: the row index)."""
        item_ids = np.ascontiguousarray(item_ids, np.int64)
        n, itf = item_ids.shape
        if itf != self.model.itf:
            raise ValueError(f"items carry {itf} features, model expects {self.model.itf}")
        dim = self.scoring.table_cfg.dim
        out = []
        for s in range(0, n, self.embed_batch):
            ids = item_ids[s:s + self.embed_batch]
            rows = self.scoring.table.lookup(ids.reshape(-1), train=False)
            out.append(self.model.embed_item(rows.reshape(len(ids), itf, dim)))
        self.index = ItemIndex(torch.cat(out), keys=keys, dtype=self.index_dtype,
                               device=self.scoring.device)
        # item-feature tuple -> external key, for recall@k: the rows sorted as
        # bytes; a tuple listed twice maps to its last key, as a dict would
        rows = item_ids.view(np.dtype((np.void, 8 * itf))).reshape(-1)
        order = np.argsort(rows, kind="stable")
        self._rows, self._row_keys = rows[order], self.index.keys[order]
        return self.index

    def _truth(self, item_rows: np.ndarray) -> np.ndarray:
        """[P, IF] item-feature rows -> [P] external keys; rows absent from
        the corpus get -2^62, which no key equals."""
        q = np.ascontiguousarray(item_rows, np.int64).view(self._rows.dtype).reshape(-1)
        pos = np.searchsorted(self._rows, q, side="right") - 1
        hit = (pos >= 0) & (self._rows[np.maximum(pos, 0)] == q)
        return np.where(hit, self._row_keys[np.maximum(pos, 0)], np.int64(-(1 << 62)))

    def evaluate(self, batches, ks=(1, 10, 100)) -> dict:
        """Recall@k over labelled (query, item) batches: for every positive
        example, whether the top-k over the corpus holds its item. Items
        absent from the corpus count as misses. One-hot [B, S] batches."""
        if self.index is None:
            raise RuntimeError("call build_index() first")
        ks = sorted(int(k) for k in ks)
        qf = self.model.qf
        hits = {k: 0 for k in ks}
        total = 0
        for batch in batches:
            ids = np.asarray(batch["ids"], np.int64)
            if ids.ndim != 2:
                raise ValueError(f"retrieval eval expects one-hot [B, S] ids, got {ids.shape}")
            pos = np.asarray(batch["label"]).reshape(-1) > 0
            if not pos.any():
                continue
            truth = self._truth(ids[pos, qf:])
            got, _ = self.retrieve(np.asarray(batch["dense"], np.float32)[pos], ids[pos, :qf],
                                   k=ks[-1])
            for k in ks:
                hits[k] += int((got[:, :k] == truth[:, None]).any(1).sum())
            total += int(pos.sum())
        return {
            **{f"recall@{k}": (hits[k] / total if total else None) for k in ks},
            "positives": total,
            "corpus": self.index.num_items,
        }

    @torch.no_grad()
    def retrieve(self, dense, query_ids, k: int = 10):
        """dense [Q, ND] + query-side ids [Q, QF] -> (keys [Q, k], scores)."""
        if self.index is None:
            raise RuntimeError("call build_index() first")
        query_ids = np.asarray(query_ids, np.int64)
        q, qf = query_ids.shape
        if qf != self.model.qf:
            raise ValueError(f"queries carry {qf} features, model expects {self.model.qf}")
        dim = self.scoring.table_cfg.dim
        rows = self.scoring.table.lookup(query_ids.reshape(-1), train=False)
        dense_t = _tensor(np.asarray(dense, np.float32), self.scoring.device, torch.float32)
        vecs = self.model.embed_query(dense_t, rows.reshape(q, qf, dim))
        return self.index.topk(vecs, k)
