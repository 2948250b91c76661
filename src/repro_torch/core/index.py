"""KNN-Index structure (Definition 4.1) and query processing (§4.1).

The index is exactly what the paper stores: for every vertex v, the top-k
nearest candidate objects in increasing distance order. Query = O(k) scan
(Theorem 4.3, optimal); progressive output of the i-th result in O(i)
(Theorem 4.4); size O(n*k) (Theorem 4.5).

``KNNIndex`` is the *host* view: plain numpy tables plus scalar per-call
queries, kept as the readable reference the oracles (core/reference.py,
core/updates.py) operate on. Production serving goes through the
device-resident ``repro_torch.core.engine.QueryEngine`` (batched queries, staged
updates, save/load), re-exported with this class from the stable
``repro_torch.knn`` facade.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

PAD_ID = -1
PAD_DIST = np.inf


@dataclasses.dataclass
class KNNIndex:
    """ids[v, i] = i-th nearest object of v; dists[v, i] = its distance."""

    ids: np.ndarray    # (n, k) int32, PAD_ID padded
    dists: np.ndarray  # (n, k) float64, PAD_DIST padded
    k: int

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    def _check_k(self, k: int | None) -> int:
        if k is None:
            return self.k
        if k > self.k:
            raise ValueError(
                f"query k={k} exceeds index k={self.k}: a k'-NN query is only "
                f"answerable from a KNN-Index built with k >= k' (Section 4.2)"
            )
        return k

    def query(self, u: int, k: int | None = None) -> list[tuple[int, float]]:
        """Answer a kNN query by scanning the u-th row — O(k), Theorem 4.3.

        Raises ValueError when k exceeds the index's k: the row only stores
        the k nearest objects, so a larger query cannot be answered.
        """
        kk = self._check_k(k)
        row_ids = self.ids[u, :kk]
        row_d = self.dists[u, :kk]
        sel = row_ids != PAD_ID
        return list(zip(row_ids[sel].tolist(), row_d[sel].tolist()))

    def query_progressive(self, u: int, k: int | None = None) -> Iterator[tuple[int, float]]:
        """Progressive query processing: yields the i-th result in O(1) more
        work after the (i-1)-th (Theorem 4.4, incremental polynomial)."""
        kk = self._check_k(k)
        for i in range(kk):
            v = int(self.ids[u, i])
            if v == PAD_ID:
                return
            yield v, float(self.dists[u, i])

    def size_bytes(self, id_bytes: int = 4, dist_bytes: int = 8) -> int:
        """Size in bytes of the stored tables: n*k (id + dist) entries.

        The paper's O(n*k) size bound (Theorem 4.5, Exp-5/6) counts 4-byte
        ids and 4-byte float distances — n*k*8 bytes, what the device tables
        (int32/float32) occupy; call ``size_bytes(dist_bytes=4)`` for that
        figure. The defaults describe *this* host object, whose ``dists``
        are float64 so the update oracles accumulate in full precision.
        """
        return self.n * self.k * (id_bytes + dist_bytes)

    def copy(self) -> "KNNIndex":
        return KNNIndex(ids=self.ids.copy(), dists=self.dists.copy(), k=self.k)


def index_from_lists(n: int, k: int, rows: list[list[tuple[int, float]]]) -> KNNIndex:
    ids = np.full((n, k), PAD_ID, dtype=np.int32)
    dists = np.full((n, k), PAD_DIST, dtype=np.float64)
    for v, row in enumerate(rows):
        for i, (obj, d) in enumerate(row[:k]):
            ids[v, i] = obj
            dists[v, i] = d
    return KNNIndex(ids=ids, dists=dists, k=k)


def indices_equivalent(a: KNNIndex, b: KNNIndex, *, atol: float = 1e-9) -> bool:
    """Equality up to ties: the distance rows must match exactly; ids may
    differ only where distances tie.

    Rows are sorted by distance, so an entry's distance is ambiguous (a tie)
    exactly when it equals an adjacent entry's distance; everywhere else the
    object id is uniquely determined and must match — except in the last slot
    of a *full* row, where a tie can hide below the cut: the k-th and the
    discarded (k+1)-th candidate may sit at the same distance, and the update
    algorithms (checkIns prunes at d < kth) legitimately keep either one.
    """
    if a.n != b.n or a.k != b.k:
        return False
    da = np.where(np.isinf(a.dists), -1.0, a.dists)
    db = np.where(np.isinf(b.dists), -1.0, b.dists)
    if not np.allclose(da, db, atol=atol):
        return False
    tie = np.zeros(da.shape, dtype=bool)
    if a.k > 1:
        adj = np.isclose(da[:, 1:], da[:, :-1], atol=atol)
        tie[:, 1:] |= adj
        tie[:, :-1] |= adj
    tie[:, -1] |= a.ids[:, -1] != PAD_ID  # full row: boundary tie is invisible
    unique = ~tie & np.isfinite(a.dists)
    return bool(np.array_equal(a.ids[unique], b.ids[unique]))
