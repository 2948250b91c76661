"""Host (numpy/python) reference implementations of the paper's algorithms.

These are the faithful, sequential forms:
  - dijkstra_knn / dijkstra_cons  : the paper's Dijkstra baselines
  - vk_less_sweep                 : lines 3-7 shared by Algorithms 2 and 3
  - knn_index_cons                : Algorithm 2  (bottom-up + per-vertex Dijkstra)
  - knn_index_cons_plus           : Algorithm 3  (bidirectional, no Dijkstra)

They serve as oracles for the device-side level-synchronous construction
(construct.py) and as the paper-faithful baselines in benchmarks.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.bngraph import BNGraph
from repro_torch.core.index import KNNIndex, index_from_lists
from repro_torch.graph.csr import Graph


def _topk(cands: dict[int, float], k: int) -> list[tuple[int, float]]:
    """k smallest (dist, id) with distinct ids; deterministic tie-break by id."""
    return [(v, d) for d, v in heapq.nsmallest(k, ((d, v) for v, d in cands.items()))]


# ---------------------------------------------------------------------------
# Dijkstra oracle / baseline (Section 1 "straightforward approach")
# ---------------------------------------------------------------------------

def dijkstra_knn(g: Graph, is_object: np.ndarray, k: int, u: int) -> list[tuple[int, float]]:
    """Exact kNN by Dijkstra from u, early-terminated after k objects."""
    dist = np.full(g.n, np.inf)
    dist[u] = 0.0
    heap = [(0.0, u)]
    out: list[tuple[int, float]] = []
    while heap and len(out) < k:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        if is_object[v]:
            out.append((v, d))
        nbrs, ws = g.neighbors(v)
        for nb, w in zip(nbrs.tolist(), ws.tolist()):
            nd = d + w
            if nd < dist[nb]:
                dist[nb] = nd
                heapq.heappush(heap, (nd, nb))
    return out


def dijkstra_cons(g: Graph, objects: np.ndarray, k: int) -> KNNIndex:
    """Dijkstra-Cons baseline: n independent Dijkstra searches (Exp-4)."""
    is_object = np.zeros(g.n, dtype=bool)
    is_object[objects] = True
    rows = [dijkstra_knn(g, is_object, k, u) for u in range(g.n)]
    return index_from_lists(g.n, k, rows)


# ---------------------------------------------------------------------------
# Shared bottom-up sweep: decreasing-rank partial kNN  V_k^<  (Lemmas 5.11-5.14)
# ---------------------------------------------------------------------------

def vk_less_sweep(bn: BNGraph, objects: np.ndarray, k: int) -> list[list[tuple[int, float]]]:
    is_object = np.zeros(bn.n, dtype=bool)
    is_object[objects] = True
    vk_less: list[list[tuple[int, float]]] = [[] for _ in range(bn.n)]
    for r in range(bn.n):
        u = int(bn.order[r])
        cands: dict[int, float] = {u: 0.0} if is_object[u] else {}
        for w, phi in bn.bns_lower(u):
            for v, dwv in vk_less[w]:
                nd = phi + dwv
                old = cands.get(v)
                if old is None or nd < old:
                    cands[v] = nd
        vk_less[u] = _topk(cands, k)
    return vk_less


# ---------------------------------------------------------------------------
# Algorithm 2: bottom-up construction (BFS + Dijkstra over G'^>(u))
# ---------------------------------------------------------------------------

def knn_index_cons(bn: BNGraph, objects: np.ndarray, k: int) -> KNNIndex:
    vk_less = vk_less_sweep(bn, objects, k)
    adj = bn.adjacency()
    rank = bn.rank
    rows: list[list[tuple[int, float]]] = [[] for _ in range(bn.n)]
    for r in range(bn.n):
        u = int(bn.order[r])
        # line 9: construct G'^>(u) by BFS following increasing-rank edges.
        reach = {u}
        stack = [u]
        while stack:
            v = stack.pop()
            for nb in adj[v]:
                if rank[nb] > rank[v] and nb not in reach:
                    reach.add(nb)
                    stack.append(nb)
        # lines 10-11: Dijkstra from u inside G'^>(u). Edges of the subgraph:
        # (a,b) with a in reach and rank[b] > rank[a] (then b in reach too).
        dist_sub: dict[int, float] = {u: 0.0}
        heap = [(0.0, u)]
        while heap:
            d, v = heapq.heappop(heap)
            if d > dist_sub.get(v, np.inf):
                continue
            for nb, w in adj[v].items():
                if nb not in reach:
                    continue
                a, b = (v, nb) if rank[v] < rank[nb] else (nb, v)
                if a not in reach:
                    continue
                nd = d + w
                if nd < dist_sub.get(nb, np.inf):
                    dist_sub[nb] = nd
                    heapq.heappush(heap, (nd, nb))
        # lines 12-15: merge V_k^< of every w in G'^>(u) shifted by dist_sub.
        cands: dict[int, float] = {}
        for w in reach:
            dw = dist_sub.get(w, np.inf)
            for v, dv in vk_less[w]:
                nd = dw + dv
                old = cands.get(v)
                if old is None or nd < old:
                    cands[v] = nd
        rows[u] = _topk(cands, k)
    return index_from_lists(bn.n, k, rows)


# ---------------------------------------------------------------------------
# Algorithm 3: bidirectional construction (the paper's headline algorithm)
# ---------------------------------------------------------------------------

def knn_index_cons_plus(bn: BNGraph, objects: np.ndarray, k: int) -> KNNIndex:
    vk_less = vk_less_sweep(bn, objects, k)
    rows: list[list[tuple[int, float]]] = [[] for _ in range(bn.n)]
    for r in range(bn.n - 1, -1, -1):
        u = int(bn.order[r])
        cands: dict[int, float] = dict(vk_less[u])  # dist_<(u, .) term (Lemma 5.22)
        for w, phi in bn.bns_higher(u):
            for v, dwv in rows[w]:
                nd = phi + dwv
                old = cands.get(v)
                if old is None or nd < old:
                    cands[v] = nd
        rows[u] = _topk(cands, k)
    return index_from_lists(bn.n, k, rows)
