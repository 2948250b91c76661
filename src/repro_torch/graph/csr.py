"""CSR graph substrate for road networks.

Undirected weighted graphs stored in CSR form. All the paper's structures
(BN-Graph, KNN-Index) are built on top of this representation; the torch layers
consume the padded-dense views derived from it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected weighted graph in CSR form (each edge stored twice)."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (2m,) int32 neighbor ids
    weights: np.ndarray  # (2m,) float64 edge weights

    @property
    def m(self) -> int:
        return int(self.indices.shape[0] // 2)

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[v], self.indptr[v + 1]
        return self.indices[s:e], self.weights[s:e]

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(u, v, w) with u < v, each undirected edge once."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        mask = src < self.indices
        return src[mask], self.indices[mask], self.weights[mask]

    def adjacency_dicts(self) -> list[dict[int, float]]:
        """Mutable dict-of-dicts adjacency (used by the elimination passes)."""
        adj: list[dict[int, float]] = [dict() for _ in range(self.n)]
        for v in range(self.n):
            s, e = self.indptr[v], self.indptr[v + 1]
            for u, w in zip(self.indices[s:e].tolist(), self.weights[s:e].tolist()):
                old = adj[v].get(u)
                if old is None or w < old:
                    adj[v][u] = w
        return adj

    def to_dense_padded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded (n, dmax) neighbor/weight tables; pad id = -1, pad w = +inf."""
        deg = self.degrees()
        dmax = int(deg.max()) if self.n else 0
        nbr = np.full((self.n, dmax), -1, dtype=np.int32)
        wts = np.full((self.n, dmax), np.inf, dtype=np.float64)
        for v in range(self.n):
            s, e = self.indptr[v], self.indptr[v + 1]
            nbr[v, : e - s] = self.indices[s:e]
            wts[v, : e - s] = self.weights[s:e]
        return nbr, wts, deg


@dataclasses.dataclass(frozen=True)
class PaddedCSR:
    """Dual padded-dense + CSR view of a (possibly non-simple) adjacency.

    The padded form is what device gathers consume: ``ids``/``w`` are
    ``(n+1, t)`` with valid neighbors compacted to the front of each row
    (a row of degree d is fully described by its first d columns), ``-1`` /
    ``+inf`` pads behind them, and a trailing all-pad dummy row so batched
    row gathers can clamp padding to row ``n``. The CSR triple
    (``indptr``, ``indices``, ``weights``) is the same adjacency without
    padding, for host-side set algebra (frontier expansion, audits).
    Weights are float32 — the dtype the device pipelines run in.
    """

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    weights: np.ndarray  # (nnz,) float32
    ids: np.ndarray      # (n+1, t) int32, -1 padded, valid-first per row
    w: np.ndarray        # (n+1, t) float32, +inf on pads
    deg: np.ndarray      # (n+1,) int32 per-row valid count (dummy row: 0)

    def relayout_rows(self, padded_rows: int, row_of_v: np.ndarray) -> np.ndarray:
        """Neighbor-id table re-laid into a partitioned row layout.

        ``row_of_v`` maps vertex v to its row in a ``padded_rows``-row
        partitioned layout (the sharded engine's vertex -> global-padded-row
        map); the result holds vertex v's padded neighbor ids at
        ``row_of_v[v]`` and all ``-1`` on the layout's pad rows — the
        per-shard CSR slice the device receiver-set expansion gathers from.
        """
        out = np.full((padded_rows, self.ids.shape[1]), -1, np.int32)
        out[np.asarray(row_of_v, np.int64)] = self.ids[: self.n]
        return out


def padded_csr(ids: np.ndarray, w: np.ndarray) -> PaddedCSR:
    """Build a ``PaddedCSR`` from raw padded ``(n, t)`` id/weight tables.

    Input rows may hold ``-1`` pads anywhere; the output compacts valid
    entries to the front (stable, preserving input column order), derives
    the CSR triple from the compacted rows and appends the dummy row.
    """
    ids = np.asarray(ids, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32).copy()
    n = ids.shape[0]
    w[ids < 0] = np.inf
    order = np.argsort(ids < 0, axis=1, kind="stable")  # valid entries first
    ids = np.take_along_axis(ids, order, axis=1)
    w = np.take_along_axis(w, order, axis=1)
    deg = (ids >= 0).sum(axis=1).astype(np.int32)
    valid = ids >= 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    ids_p = np.concatenate([ids, np.full((1, ids.shape[1]), -1, np.int32)])
    w_p = np.concatenate([w, np.full((1, w.shape[1]), np.inf, np.float32)])
    return PaddedCSR(
        n=n,
        indptr=indptr,
        indices=ids[valid].ravel(),
        weights=w[valid].ravel(),
        ids=ids_p,
        w=w_p,
        deg=np.concatenate([deg, np.zeros(1, np.int32)]),
    )


def from_edges(n: int, edges: Iterable[tuple[int, int, float]]) -> Graph:
    """Build a Graph from an iterable of (u, v, w); parallel edges keep min w."""
    best: dict[tuple[int, int], float] = {}
    for u, v, w in edges:
        if u == v:
            continue
        key = (u, v) if u < v else (v, u)
        old = best.get(key)
        if old is None or w < old:
            best[key] = float(w)
    us = np.empty(2 * len(best), dtype=np.int32)
    vs = np.empty(2 * len(best), dtype=np.int32)
    ws = np.empty(2 * len(best), dtype=np.float64)
    for i, ((u, v), w) in enumerate(best.items()):
        us[2 * i], vs[2 * i], ws[2 * i] = u, v, w
        us[2 * i + 1], vs[2 * i + 1], ws[2 * i + 1] = v, u, w
    order = np.lexsort((vs, us))
    us, vs, ws = us[order], vs[order], ws[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, us + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(n=n, indptr=indptr, indices=vs, weights=ws)


def from_adjacency_dicts(adj: Sequence[dict[int, float]]) -> Graph:
    n = len(adj)
    edges = []
    for u, nbrs in enumerate(adj):
        for v, w in nbrs.items():
            if u < v:
                edges.append((u, v, w))
    return from_edges(n, edges)


def is_connected(g: Graph) -> bool:
    if g.n == 0:
        return True
    seen = np.zeros(g.n, dtype=bool)
    stack = [0]
    seen[0] = True
    count = 1
    while stack:
        v = stack.pop()
        nbrs, _ = g.neighbors(v)
        for u in nbrs:
            if not seen[u]:
                seen[u] = True
                count += 1
                stack.append(int(u))
    return count == g.n
