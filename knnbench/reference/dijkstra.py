"""Exact kNN by Dijkstra, a frozen copy of the port's
``core/reference.dijkstra_knn`` over the benchmark's own CSR.

Vertices leave the heap in (distance, id) order, so among objects at one
distance the smaller id comes first: the order the index's rows hold.
"""
from __future__ import annotations

import heapq

import numpy as np


class Dijkstra:
    """kNN searches over one network (Python adjacency lists, built once)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray):
        self.n = len(indptr) - 1
        nbrs = indices.tolist()
        ws = weights.tolist()
        bounds = indptr.tolist()
        self.adj = [list(zip(nbrs[bounds[v]:bounds[v + 1]], ws[bounds[v]:bounds[v + 1]]))
                    for v in range(self.n)]

    def knn(self, is_object: np.ndarray, k: int, u: int) -> list[tuple[int, float]]:
        """The k nearest objects of u as (id, distance), nearest first."""
        dist = {u: 0.0}
        heap = [(0.0, u)]
        out: list[tuple[int, float]] = []
        while heap and len(out) < k:
            d, v = heapq.heappop(heap)
            if d > dist[v]:
                continue
            if is_object[v]:
                out.append((v, d))
            for nb, w in self.adj[v]:
                nd = d + w
                if nd < dist.get(nb, np.inf):
                    dist[nb] = nd
                    heapq.heappush(heap, (nd, nb))
        return out
