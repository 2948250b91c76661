"""Stable public facade for the kNN road-network system (PyTorch + CUDA).

One import surface for the pipeline this package covers: build, serve,
maintain.

    from repro_torch import knn

    g = knn.road_network(64, 64, seed=0)
    objects = knn.pick_objects(g.n, 0.02, seed=0)
    engine = knn.build_engine(g, objects, k=20)        # device sweeps end to end

    ids, dists = engine.query_batch(us)                # batched O(k) serving
    engine.stage_insert(u); engine.stage_delete(v)
    engine.stage_move(a, b)                            # moving-objects traffic
    engine.flush_updates()                             # one fused batch repair

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a CUDA
device it raises unless ``device="cpu"`` is passed, which runs the plain
PyTorch versions of the kernels. Every error the system raises subclasses
``RepError`` (``repro_torch.core.errors``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bngraph import BNGraph, build_bngraph
from repro_torch.core.construct import build_knn_index, build_knn_tables
from repro_torch.core.engine import QueryEngine
from repro_torch.core.errors import (
    EngineConfigError,
    EpochError,
    QueryError,
    RepError,
    StagedUpdateError,
)
from repro_torch.core.index import KNNIndex, indices_equivalent
from repro_torch.core.reference import knn_index_cons_plus
from repro_torch.core.updates import delete_object, insert_object, move_object
from repro_torch.graph.csr import Graph
from repro_torch.graph.generators import pick_objects, road_network

__all__ = [
    "BNGraph",
    "EngineConfigError",
    "EpochError",
    "Graph",
    "KNNIndex",
    "QueryEngine",
    "QueryError",
    "RepError",
    "StagedUpdateError",
    "build_bngraph",
    "build_engine",
    "build_index",
    "build_knn_index",
    "build_knn_tables",
    "delete_object",
    "indices_equivalent",
    "insert_object",
    "knn_index_cons_plus",
    "move_object",
    "pick_objects",
    "road_network",
    "stage_random_updates",
]


def build_engine(
    graph: Graph | BNGraph,
    objects: np.ndarray,
    k: int,
    *,
    device="cuda",
    use_kernel: bool = True,
) -> QueryEngine:
    """Road network (or prebuilt BN-Graph) -> serving engine, on device."""
    bn = graph if isinstance(graph, BNGraph) else build_bngraph(graph)
    return QueryEngine.build(bn, objects, k, device=device, use_kernel=use_kernel)


def build_index(
    graph: Graph | BNGraph,
    objects: np.ndarray,
    k: int,
    *,
    device="cuda",
    use_kernel: bool = True,
) -> KNNIndex:
    """Road network (or prebuilt BN-Graph) -> host KNNIndex view."""
    bn = graph if isinstance(graph, BNGraph) else build_bngraph(graph)
    return build_knn_index(bn, objects, k, device=device, use_kernel=use_kernel)


def stage_random_updates(engine: QueryEngine, mset: set, rng=None, count: int = 1) -> int:
    """Stage ``count`` random net object updates (the benchmark workload mix).

    Draws uniform vertices from ``[0, engine.n)``: a present one is staged for
    deletion (skipped while |M| <= k+1 so rows stay full through the churn),
    an absent one for insertion. ``mset`` is the caller's membership mirror
    and is kept in sync.

    ``rng`` may be a ``numpy.random.Generator``, an int seed, or None (a fresh
    ``np.random.default_rng(0)``, so repeated runs that rely on the default
    draw the SAME update sequence). Returns the number staged, possibly fewer
    than ``count`` when the draw budget runs out; the caller decides when to
    flush.
    """
    if rng is None or isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(0 if rng is None else int(rng))
    staged = 0
    for _ in range(max(16, 16 * count)):
        if staged >= count:
            break
        v = int(rng.integers(0, engine.n))
        if v in mset and len(mset) > engine.k + 1:
            engine.stage_delete(v)
            mset.discard(v)
        elif v not in mset:
            engine.stage_insert(v)
            mset.add(v)
        else:
            continue
        staged += 1
    return staged
