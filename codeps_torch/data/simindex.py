"""Exact flat inner-product index with external ids.

Counterpart of the numpy path of ``codeps_tpu/native/simindex.py`` (the
replay buffer's stand-in for ``faiss.IndexIDMap(IndexFlatIP)``). The
buffer holds at most a few hundred vectors of 2048 floats, so one matrix
product per query is the whole search.
"""

from __future__ import annotations

import numpy as np


class SimIndex:
    """Exact inner-product index; vectors keep their insertion order."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self._vectors = np.zeros((0, self.dim), np.float32)
        self._ids = np.zeros((0,), np.int64)

    @property
    def ntotal(self) -> int:
        return int(self._ids.shape[0])

    def add_with_ids(self, vectors: np.ndarray, ids: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        if vectors.shape != (ids.shape[0], self.dim):
            raise ValueError(f"vectors {vectors.shape} do not match "
                             f"{ids.shape[0]} ids of dim {self.dim}")
        self._vectors = np.concatenate([self._vectors, vectors])
        self._ids = np.concatenate([self._ids, ids])

    def search(self, queries: np.ndarray, k: int):
        """(scores (nq, k) descending, ids (nq, k)); -inf and -1 pad."""
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.dim:
            raise ValueError(f"query width {queries.shape[1]} != index dim "
                             f"{self.dim}")
        nq = queries.shape[0]
        if self.ntotal == 0:
            return (np.full((nq, k), -np.inf, np.float32),
                    np.full((nq, k), -1, np.int64))
        sims = queries @ self._vectors.T
        order = np.argsort(-sims, axis=1, kind="stable")[:, :k]
        top_scores = np.take_along_axis(sims, order, axis=1)
        top_ids = self._ids[order]
        if order.shape[1] < k:
            pad = k - order.shape[1]
            top_scores = np.pad(top_scores, ((0, 0), (0, pad)),
                                constant_values=-np.inf)
            top_ids = np.pad(top_ids, ((0, 0), (0, pad)),
                             constant_values=-1)
        return top_scores.astype(np.float32), top_ids

    def remove_ids(self, ids: np.ndarray) -> int:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        keep = ~np.isin(self._ids, ids)
        removed = int((~keep).sum())
        self._vectors = self._vectors[keep]
        self._ids = self._ids[keep]
        return removed

    def dump(self):
        """(ids, vectors) in insertion order."""
        return self._ids.copy(), self._vectors.copy()
