"""Candidate-object update maintenance — Algorithms 4 (insert) and 5 (delete),
plus their composition ``move_object`` (the moving-objects workload primitive).

Both propagate from the updated object u over BNS edges, pruned by the current
k-th distance of each visited vertex (checkIns / checkDel). We use a distance-
ordered frontier (lazy-deletion heap) rather than the paper's FIFO queue: it
explores the same pruned region but guarantees dist[v] is settled exactly when
v is expanded, which is the invariant the paper's Theorems 6.2/6.4 assert.

This module is the scalar *host reference oracle*: one update at a time
against the numpy ``KNNIndex``. The production path is the batched,
device-resident staged-update queue of ``repro_torch.core.engine.QueryEngine``,
which is property-tested to be ``indices_equivalent`` to a sequential replay
through these functions. ``insert_affected_set`` is shared: the engine runs
the same checkIns frontier against its k-th-distance mirror.
"""
from __future__ import annotations

import heapq
from typing import Callable

import numpy as np

from repro_torch.core.bngraph import BNGraph
from repro_torch.core.index import PAD_DIST, PAD_ID, KNNIndex


def _kth_dist(index: KNNIndex, v: int) -> float:
    """Distance of v's current k-th nearest object (+inf if the row is short)."""
    row = index.dists[v]
    if index.ids[v, -1] == PAD_ID:
        return np.inf
    return float(row[-1])


def insert_affected_set(
    bn: BNGraph, kth_of: Callable[[int], float], u: int
) -> dict[int, float]:
    """checkIns frontier search (Algorithm 4 lines 1-8): the set S of vertices
    whose V_k the insertion of u changes, with exact dist(u, v) for each.

    ``kth_of(v)`` must return v's current k-th nearest distance (+inf when the
    row is short); both the scalar oracle and the batched engine call through
    here so their pruned regions coincide.
    """
    dist: dict[int, float] = {u: 0.0}
    settled: set[int] = set()
    affected: dict[int, float] = {}
    heap: list[tuple[float, int]] = [(0.0, u)]
    while heap:
        d, w = heapq.heappop(heap)
        if w in settled or d > dist.get(w, np.inf):
            continue
        settled.add(w)
        if not (d < kth_of(w) or w == u):  # checkIns
            continue  # V_k(w) unaffected -> propagation stops here (Lemma 6.1)
        affected[w] = d
        for v, phi in bn.bns(w):
            nd = d + phi
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return affected


def _affected_set(
    bn: BNGraph, index: KNNIndex, u: int, *, for_delete: bool
) -> dict[int, float]:
    """Shared frontier search of Algorithms 4/5 (lines 1-8): the set S of
    vertices whose V_k may change, with exact dist(u, v) for each."""
    if not for_delete:
        return insert_affected_set(bn, lambda v: _kth_dist(index, v), u)
    dist: dict[int, float] = {u: 0.0}
    settled: set[int] = set()
    affected: dict[int, float] = {}
    heap: list[tuple[float, int]] = [(0.0, u)]
    while heap:
        d, w = heapq.heappop(heap)
        if w in settled or d > dist.get(w, np.inf):
            continue
        settled.add(w)
        in_row = bool(np.any(index.ids[w] == u))
        if not (in_row and d <= _kth_dist(index, w)):  # checkDel
            continue  # V_k(w) unaffected -> propagation stops here (Lemma 6.1)
        affected[w] = d
        for v, phi in bn.bns(w):
            nd = d + phi
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return affected


def insert_object(bn: BNGraph, index: KNNIndex, u: int) -> int:
    """Algorithm 4: insert object u; returns |S| (the paper's Delta)."""
    affected = _affected_set(bn, index, u, for_delete=False)
    for v, d in affected.items():
        row_ids, row_d = index.ids[v], index.dists[v]
        # lines 9-10: drop v_k, insert (u, d) at its sorted position.
        pos = int(np.searchsorted(row_d, d, side="right"))
        if pos >= index.k:
            continue
        row_ids[pos + 1 :] = row_ids[pos:-1]
        row_d[pos + 1 :] = row_d[pos:-1]
        row_ids[pos] = u
        row_d[pos] = d
    return len(affected)


def move_object(bn: BNGraph, index: KNNIndex, u: int, v: int) -> int:
    """Object movement: the object at vertex u relocates to vertex v.

    The scalar host oracle for ``QueryEngine.stage_move``: Algorithm 4 at the
    destination followed by Algorithm 5 at the source. Insertion runs first
    so rows never go transiently deficient — the final index is a pure
    function of the object set (Theorems 6.2/6.4), so the order only affects
    intermediate states. The caller guarantees u is an object and v is not
    (same contract as insert_object/delete_object). Returns the total |S|
    over both halves.
    """
    if u == v:
        raise ValueError(f"move source and destination are both {u}")
    delta = insert_object(bn, index, v)
    return delta + delete_object(bn, index, u)


def delete_object(bn: BNGraph, index: KNNIndex, u: int) -> int:
    """Algorithm 5: delete object u; returns |S|.

    processDel (lines 15-18) finds the replacement from neighbors' lists. We
    run the decreasing-rank pass to a fixpoint: a second pass is needed when a
    replacement's shortest path runs through a *lower*-ranked neighbor whose
    own row was repaired after v's (the paper's single pass leaves this case
    implicit); the loop almost always converges in one pass.
    """
    affected = _affected_set(bn, index, u, for_delete=True)
    order = sorted(affected, key=lambda v: -int(bn.rank[v]))
    # Remove u everywhere first so stale entries never act as candidates.
    for v in order:
        row_ids, row_d = index.ids[v], index.dists[v]
        keep = row_ids != u
        nk = int(keep.sum())
        index.ids[v, :nk] = row_ids[keep]
        index.dists[v, :nk] = row_d[keep]
        index.ids[v, nk:] = PAD_ID
        index.dists[v, nk:] = PAD_DIST
    # processDel to fixpoint: tentative replacement per deficient row, refined
    # until stable (replacement distances only ever decrease -> terminates).
    repl: dict[int, tuple[int, float]] = {}
    deficient = [v for v in order if index.ids[v, -1] == PAD_ID]
    present_sets = {
        v: set(index.ids[v][index.ids[v] != PAD_ID].tolist()) for v in deficient
    }
    changed = True
    while changed:
        changed = False
        for v in deficient:
            present = present_sets[v]
            best_id, best_d = repl.get(v, (PAD_ID, np.inf))
            for w, phi in bn.bns(v):
                for j in range(index.k):
                    cid = int(index.ids[w, j])
                    if cid == PAD_ID:
                        break
                    if cid in present:
                        continue
                    nd = phi + float(index.dists[w, j])
                    if nd < best_d:
                        best_id, best_d = cid, nd
                rw = repl.get(w)
                if rw is not None and rw[0] not in present:
                    nd = phi + rw[1]
                    if nd < best_d:
                        best_id, best_d = rw[0], nd
            if best_id != PAD_ID and (v not in repl or best_d < repl[v][1]):
                repl[v] = (best_id, best_d)
                changed = True
    for v, (rid, rd) in repl.items():
        nk = int((index.ids[v] != PAD_ID).sum())
        index.ids[v, nk] = rid
        index.dists[v, nk] = rd
    return len(affected)
