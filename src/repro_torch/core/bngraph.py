"""BN-Graph construction — Algorithm 1 (SD-Graph-Gen) of the paper.

Builds the bridge-neighbor-preserved graph G' of a road network G:
  (1) V(G') = V(G)
  (2) every edge weight in G' equals the true shortest distance in G
  (3) all pairwise shortest distances are preserved.

Step 1 (edge insertion) is the classic contraction-style elimination: process
vertices in increasing rank order, and form a clique (with min-plus weights)
among the still-unprocessed (= higher-ranked) neighbors of each processed
vertex. Step 2 (edge deletion) walks ranks downward and replaces every edge
weight by the exact distance, deleting edges that are not bridges.

The vertex order is the paper's dynamic minimum-degree heuristic by default
(Section 5.2 Remark): the next vertex is the one with the fewest *unprocessed*
neighbors in the current G'. 'degree' (static) and 'id' orders are provided
for the Exp-10 reproduction.

This pass mutates graph structure dynamically and is therefore kept on the
host (numpy/python), exactly as sparse direct solvers keep symbolic
factorisation on CPU; the numeric sweeps that dominate construction time run
on the GPU (see construct.py).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.graph.csr import Graph, PaddedCSR, padded_csr


@dataclasses.dataclass
class BNGraph:
    """The bridge-neighbor preserved graph G' plus the schedule metadata."""

    n: int
    rank: np.ndarray            # (n,) int64: rank[v] = position of v in pi
    order: np.ndarray           # (n,) int64: order[r] = vertex with rank r
    # Final G' adjacency split by rank direction, padded with -1 / +inf:
    lo_ids: np.ndarray          # (n, tau_lo) int32   BNS^<(v)
    lo_w: np.ndarray            # (n, tau_lo) float64 exact distances
    hi_ids: np.ndarray          # (n, tau_hi) int32   BNS^>(v)
    hi_w: np.ndarray            # (n, tau_hi) float64 exact distances
    # Level schedule (ours): levels_up for the bottom-up sweep over BNS^<,
    # levels_down for the top-down sweep over BNS^>.
    level_up: np.ndarray        # (n,) int32
    level_down: np.ndarray      # (n,) int32
    rho: int                    # max degree after step 1 (paper's rho)

    @property
    def tau(self) -> int:
        """max |BNS^>(v)| (paper's tau)."""
        return int((self.hi_ids >= 0).sum(axis=1).max())

    @property
    def tau_all(self) -> int:
        """max |BNS(v)| (paper's tau')."""
        return int(((self.hi_ids >= 0).sum(axis=1) + (self.lo_ids >= 0).sum(axis=1)).max())

    def sweep_tables(self, direction: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(level_of, neighbor ids, neighbor weights) for one sweep direction.

        "up" is the bottom-up sweep over BNS^< (increasing rank), "down" the
        top-down sweep over BNS^> (decreasing rank). This is the schedule
        layout consumed by construct.prepare_sweep.
        """
        if direction == "up":
            return self.level_up, self.lo_ids, self.lo_w
        if direction == "down":
            return self.level_down, self.hi_ids, self.hi_w
        raise ValueError(f"direction must be 'up' or 'down', got {direction!r}")

    def level_members(self, direction: str) -> list[np.ndarray]:
        """Vertices of each DAG level, in level order (device sweep batches).

        Vertices within one level are mutually independent: every bridge
        neighbor a level-l vertex reads lives in a strictly earlier level.
        """
        level_of, _, _ = self.sweep_tables(direction)
        nlev = int(level_of.max()) + 1 if self.n else 0
        order = np.argsort(level_of, kind="stable")
        bounds = np.searchsorted(level_of[order], np.arange(nlev + 1))
        return [
            order[bounds[lv] : bounds[lv + 1]].astype(np.int32)
            for lv in range(nlev)
            if bounds[lv + 1] > bounds[lv]
        ]

    def bns_lower(self, v: int) -> list[tuple[int, float]]:
        ids = self.lo_ids[v]
        sel = ids >= 0
        return list(zip(ids[sel].tolist(), self.lo_w[v][sel].tolist()))

    def bns_higher(self, v: int) -> list[tuple[int, float]]:
        ids = self.hi_ids[v]
        sel = ids >= 0
        return list(zip(ids[sel].tolist(), self.hi_w[v][sel].tolist()))

    def bns(self, v: int) -> list[tuple[int, float]]:
        return self.bns_lower(v) + self.bns_higher(v)

    def bns_packed(self) -> PaddedCSR:
        """Combined BNS^< + BNS^> adjacency as one ``PaddedCSR`` (cached).

        The padded ``(n+1, t)`` tables (valid-first compacted, dummy row
        last, float32 weights) are the layout every batched device pass over
        BNS neighborhoods gathers from — the engine repair rounds and the
        batched checkIns frontier upload per-width-bucket column slices of
        them once and reuse them across flushes, replacing the per-vertex
        host ``bns()`` walk. The CSR triple serves host-side set algebra
        (e.g. expanding a changed-vertex frontier to its receiver set).
        Built on first use and memoized on the instance; treat the BNGraph
        as immutable once handed to an engine.
        """
        packed = getattr(self, "_bns_packed", None)
        if packed is None:
            packed = padded_csr(
                np.concatenate([self.lo_ids, self.hi_ids], axis=1),
                np.concatenate([self.lo_w, self.hi_w], axis=1),
            )
            self._bns_packed = packed
        return packed

    def adjacency(self) -> list[dict[int, float]]:
        adj: list[dict[int, float]] = [dict() for _ in range(self.n)]
        for v in range(self.n):
            for u, w in self.bns(v):
                adj[v][u] = w
        return adj


def _mindegree_order(adj: list[dict[int, float]]) -> np.ndarray:
    """Interleaved edge-insertion + dynamic min-degree rank (paper's order).

    Mutates adj in place (this IS step 1 of Algorithm 1); returns order.
    Ties broken by smallest vertex id, per the paper.
    """
    n = len(adj)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    heap: list[tuple[int, int]] = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    processed = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    r = 0
    while heap:
        d, w = heapq.heappop(heap)
        if processed[w] or d != deg[w]:
            continue  # stale heap entry
        processed[w] = True
        order[r] = w
        r += 1
        nbrs = [v for v in adj[w] if not processed[v]]
        # Contract w: clique among unprocessed neighbors.
        for i, u in enumerate(nbrs):
            au = adj[u]
            w_uw = adj[w][u]
            for v in nbrs[i + 1 :]:
                cand = w_uw + adj[w][v]
                old = au.get(v)
                if old is None:
                    au[v] = cand
                    adj[v][u] = cand
                    deg[u] += 1
                    deg[v] += 1
                    heapq.heappush(heap, (int(deg[v]), v))
                elif cand < old:
                    au[v] = cand
                    adj[v][u] = cand
            # processing w removes it from u's unprocessed neighborhood
            deg[u] -= 1
            heapq.heappush(heap, (int(deg[u]), u))
    return order


def _static_order_insertion(adj: list[dict[int, float]], order: np.ndarray) -> None:
    """Step 1 of Algorithm 1 under a fixed total order (Exp-10 variants)."""
    n = len(adj)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    for w in order.tolist():
        rw = rank[w]
        nbrs = [v for v in adj[w] if rank[v] > rw]
        for i, u in enumerate(nbrs):
            au = adj[u]
            w_uw = adj[w][u]
            for v in nbrs[i + 1 :]:
                cand = w_uw + adj[w][v]
                old = au.get(v)
                if old is None or cand < old:
                    au[v] = cand
                    adj[v][u] = cand


def build_bngraph(g: Graph, *, order: str | np.ndarray = "mindeg") -> BNGraph:
    """Algorithm 1: SD-Graph-Gen(G, pi) + level schedule extraction."""
    adj = g.adjacency_dicts()

    # ---- Step 1: edge insertion (+ order computation when dynamic) ----
    if isinstance(order, str) and order == "mindeg":
        order_arr = _mindegree_order(adj)
    else:
        if isinstance(order, str):
            if order == "id":
                order_arr = np.arange(g.n, dtype=np.int64)
            elif order == "degree":
                deg = g.degrees()
                order_arr = np.lexsort((np.arange(g.n), deg)).astype(np.int64)
            else:
                raise ValueError(f"unknown order {order!r}")
        else:
            order_arr = np.asarray(order, dtype=np.int64)
        _static_order_insertion(adj, order_arr)

    n = g.n
    rank = np.empty(n, dtype=np.int64)
    rank[order_arr] = np.arange(n)
    rho = max(len(a) for a in adj) if n else 0

    # ---- Step 2: edge deletion (exact-distance relaxation, decreasing rank) ----
    removed: set[tuple[int, int]] = set()
    for r in range(n - 1, -1, -1):
        w = int(order_arr[r])
        aw = adj[w]
        nbrs = [v for v in aw if rank[v] > r]
        if len(nbrs) < 2:
            continue
        snap = {v: aw[v] for v in nbrs}  # snapshot of phi(w, .) before updates
        for u in nbrs:
            best = snap[u]
            improved = False
            for v in nbrs:
                if v == u:
                    continue
                wu = adj[v].get(u)
                if wu is None:
                    continue  # (v,u) was already deleted in step 2
                cand = snap[v] + wu
                if cand < best:
                    best = cand
                    improved = True
            if improved:
                aw[u] = best
                adj[u][w] = best
                removed.add((w, u))
    for w, u in removed:
        adj[w].pop(u, None)
        adj[u].pop(w, None)

    # ---- Split adjacency by rank, pad, and derive the level schedule ----
    lo_lists: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    hi_lists: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for v in range(n):
        rv = rank[v]
        for u, wgt in adj[v].items():
            (lo_lists[v] if rank[u] < rv else hi_lists[v]).append((int(u), float(wgt)))
    for v in range(n):
        lo_lists[v].sort(key=lambda t: t[1])
        hi_lists[v].sort(key=lambda t: t[1])

    tau_lo = max((len(l) for l in lo_lists), default=0)
    tau_hi = max((len(l) for l in hi_lists), default=0)
    lo_ids = np.full((n, max(tau_lo, 1)), -1, dtype=np.int32)
    lo_w = np.full((n, max(tau_lo, 1)), np.inf, dtype=np.float64)
    hi_ids = np.full((n, max(tau_hi, 1)), -1, dtype=np.int32)
    hi_w = np.full((n, max(tau_hi, 1)), np.inf, dtype=np.float64)
    for v in range(n):
        for j, (u, wgt) in enumerate(lo_lists[v]):
            lo_ids[v, j], lo_w[v, j] = u, wgt
        for j, (u, wgt) in enumerate(hi_lists[v]):
            hi_ids[v, j], hi_w[v, j] = u, wgt

    # Level schedule: level_up via BNS^< in increasing rank order; level_down
    # via BNS^> in decreasing rank order. Vertices within a level are
    # independent, which is what lets the device sweeps batch them.
    level_up = np.zeros(n, dtype=np.int32)
    for r in range(n):
        v = int(order_arr[r])
        ids = lo_ids[v][lo_ids[v] >= 0]
        if ids.size:
            level_up[v] = int(level_up[ids].max()) + 1
    level_down = np.zeros(n, dtype=np.int32)
    for r in range(n - 1, -1, -1):
        v = int(order_arr[r])
        ids = hi_ids[v][hi_ids[v] >= 0]
        if ids.size:
            level_down[v] = int(level_down[ids].max()) + 1

    return BNGraph(
        n=n,
        rank=rank,
        order=order_arr,
        lo_ids=lo_ids,
        lo_w=lo_w,
        hi_ids=hi_ids,
        hi_w=hi_w,
        level_up=level_up,
        level_down=level_down,
        rho=rho,
    )


def bngraph_from_arrays(**fields) -> BNGraph:
    """A ``BNGraph`` from the numpy fields of another implementation's.

    Takes the dataclass fields by name (``n``, ``rank``, ``order``, ``lo_ids``,
    ``lo_w``, ``hi_ids``, ``hi_w``, ``level_up``, ``level_down``, ``rho``), as
    ``dataclasses.asdict`` of a structurally identical BN-Graph gives them, so
    two engines can be put on the identical graph without rebuilding it.
    """
    names = [f.name for f in dataclasses.fields(BNGraph)]
    missing = [name for name in names if name not in fields]
    if missing:
        raise ValueError(f"bngraph_from_arrays: missing fields {missing}")
    out = {}
    for name in names:
        value = fields[name]
        out[name] = int(value) if name in ("n", "rho") else np.array(value)
    return BNGraph(**out)
