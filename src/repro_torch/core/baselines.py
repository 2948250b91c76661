"""TEN-Index-lite: the paper's state-of-the-art baseline (Ouyang et al.,
SIGMOD'20), reimplemented at benchmark scale. The port's own copy of
``repro/core/baselines.py`` (numpy and Python only, no device code).

Three parts, exactly as §3 describes:
  1. tree decomposition (min-degree elimination; bag X(v) = v + its
     higher-ranked clique neighbors; parent = lowest-ranked bag member)
  2. H2H-style distance labels: dist(v, a) for every ancestor a  — the O(n*h)
     part that dominates TEN-Index space (169 GB of 172 GB on USA)
  3. kTNN: top-k nearest objects inside each subtree, built bottom-up with
     H2H distance queries

Query: iterate p over anc(u) + u, refine kTNN(p) by dist(u,p), k rounds.
This mirrors TEN-Index's O(h*k) query and O(n*h) space against which the
paper's O(k) / O(n*k) are measured.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.bngraph import _mindegree_order
from repro_torch.core.index import KNNIndex, index_from_lists
from repro_torch.graph.csr import Graph


class TENIndexLite:
    def __init__(self, g: Graph, objects: np.ndarray, k: int):
        self.n = g.n
        self.k = k
        adj = g.adjacency_dicts()
        order = _mindegree_order(adj)  # mutates adj = step-1 elimination
        rank = np.empty(g.n, dtype=np.int64)
        rank[order] = np.arange(g.n)
        self.rank = rank
        self.order = order

        # --- bags, parents, depths ---
        self.bag: list[list[tuple[int, float]]] = [[] for _ in range(g.n)]
        parent = np.full(g.n, -1, dtype=np.int64)
        for v in range(g.n):
            hi = [(u, w) for u, w in adj[v].items() if rank[u] > rank[v]]
            hi.sort(key=lambda t: rank[t[0]])
            self.bag[v] = hi
            if hi:
                parent[v] = hi[0][0]
        self.parent = parent
        depth = np.zeros(g.n, dtype=np.int64)
        for r in range(g.n - 1, -1, -1):
            v = order[r]
            if parent[v] >= 0:
                depth[v] = depth[parent[v]] + 1
        self.depth = depth

        # --- H2H labels: dist to every ancestor, top-down ---
        self.label: list[dict[int, float]] = [dict() for _ in range(g.n)]
        for r in range(g.n - 1, -1, -1):
            v = order[r]
            anc = self._ancestors(v)
            lab = self.label[v]
            for a in anc:
                best = np.inf
                for u, w in self.bag[v]:
                    if u == a:
                        d = w
                    elif a in self.label[u]:
                        d = w + self.label[u][a]
                    elif u in self.label[a]:
                        d = w + self.label[a][u]
                    else:
                        continue
                    if d < best:
                        best = d
                lab[a] = best

        # --- kTNN: "constructed by querying the shortest distance of
        # corresponding vertex pairs through H2H-Index" (paper §3). Every
        # object o lies in T(a) for each ancestor a, so o pushes its H2H
        # distance into the capped top-k heap of its whole ancestor chain.
        heaps: list[list[tuple[float, int]]] = [[] for _ in range(g.n)]

        def push(v: int, o: int, d: float) -> None:
            h = heaps[v]
            item = (-d, o)
            if len(h) < k:
                heapq.heappush(h, item)
            elif item > h[0]:
                heapq.heapreplace(h, item)

        for o in objects.tolist():
            push(o, o, 0.0)
            for a in self._ancestors(int(o)):
                push(a, o, self.dist(a, int(o)))
        self.ktnn: list[list[tuple[int, float]]] = [
            [(o, -nd) for nd, o in sorted(h, reverse=True)] for h in heaps
        ]

    def _ancestors(self, v: int) -> list[int]:
        out = []
        p = self.parent[v]
        while p >= 0:
            out.append(int(p))
            p = self.parent[p]
        return out

    # -- H2H-style point-to-point distance query --
    def dist(self, u: int, v: int) -> float:
        if u == v:
            return 0.0
        du, dv = self.label[u], self.label[v]
        if v in du:
            return du[v]
        if u in dv:
            return dv[u]
        # LCA by walking up
        a, b = u, v
        while a != b:
            if self.depth[a] >= self.depth[b]:
                a = int(self.parent[a])
            else:
                b = int(self.parent[b])
        x = a
        cands = [x] + [w for w, _ in self.bag[x]]
        best = np.inf
        for w in cands:
            d1 = 0.0 if w == u else du.get(w, np.inf)
            d2 = 0.0 if w == v else dv.get(w, np.inf)
            if d1 + d2 < best:
                best = d1 + d2
        return best

    # -- kNN query (paper §3: iterate anc(u)+u, refine kTNN) --
    def knn(self, u: int, k: int | None = None) -> list[tuple[int, float]]:
        kk = self.k if k is None else min(k, self.k)
        cands: dict[int, float] = {}
        for p in [u] + self._ancestors(u):
            dup = 0.0 if p == u else self.dist(u, p)
            for o, dpo in self.ktnn[p]:
                d = dup + dpo
                old = cands.get(o)
                if old is None or d < old:
                    cands[o] = d
        return [(o, d) for d, o in heapq.nsmallest(kk, ((d, o) for o, d in cands.items()))]

    def size_entries(self) -> dict[str, int]:
        h2h = sum(len(l) for l in self.label)
        ktnn = sum(len(t) for t in self.ktnn)
        bags = sum(len(b) for b in self.bag)
        return {"h2h_entries": h2h, "ktnn_entries": ktnn, "bag_entries": bags}

    def size_bytes(self) -> int:
        s = self.size_entries()
        return 8 * (s["h2h_entries"] + s["ktnn_entries"] + s["bag_entries"])

    def build_knn_index(self) -> KNNIndex:
        """TEN-Index-Cons baseline: materialise KNN-Index via TEN queries."""
        rows = [self.knn(u) for u in range(self.n)]
        return index_from_lists(self.n, self.k, rows)
