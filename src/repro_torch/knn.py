"""Stable public facade for the kNN road-network system (PyTorch + CUDA).

One import surface for the pipeline this package covers: build, serve,
maintain, persist.

    from repro_torch import knn

    g = knn.road_network(64, 64, seed=0)
    objects = knn.pick_objects(g.n, 0.02, seed=0)
    engine = knn.build_engine(g, objects, k=20)        # device sweeps end to end

    ids, dists = engine.query_batch(us)                # batched O(k) serving
    engine.stage_insert(u); engine.stage_delete(v)
    engine.stage_move(a, b)                            # moving-objects traffic
    engine.flush_updates()                             # one fused batch repair
    engine.save("index.npz")

    engine = knn.load_engine("index.npz", bn=knn.build_bngraph(g))

Moving-fleet serving (see ``repro_torch.workloads``): ``FleetSim`` drives
vehicles along shortest-path trips and each ``sim.tick()`` yields the
(src, dst) moves to stage; ``flush_updates`` applies them as one fused batch.

Vertex-sharded serving: ``build_sharded_engine(g, objects, k, plan="shards=4")``
splits the tables into S contiguous vertex ranges, S logical shards of one
padded table on one card (``repro_torch.core.sharded``), and serves the same
results as the scalar engine; ``load_engine(path, plan=...)`` reshards an
artifact on load.

Durability: ``load_engine(..., journal="wal.bin")`` attaches a write-ahead
``UpdateJournal`` and replays any records a killed process left behind
(crash recovery to identical tables, see ``repro_torch.core.journal``).
Artifacts and journals are the JAX package's formats: either package reads
what the other wrote.

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
    ArtifactError,
    EngineConfigError,
    EpochError,
    JournalError,
    QueryError,
    RepError,
    StagedUpdateError,
)
from repro_torch.core.index import KNNIndex, indices_equivalent
from repro_torch.core.journal import UpdateJournal
from repro_torch.core.partition import PartitionPlan, propose_starts
from repro_torch.core.reference import knn_index_cons_plus
from repro_torch.core.sharded import ShardedQueryEngine, ShardRoutingTable
from repro_torch.core.updates import delete_object, insert_object, move_object
from repro_torch.graph.csr import Graph
from repro_torch.graph.generators import pick_objects, road_network
from repro_torch.workloads.fleet import FleetSim

__all__ = [
    "ArtifactError",
    "BNGraph",
    "EngineConfigError",
    "EpochError",
    "FleetSim",
    "Graph",
    "JournalError",
    "KNNIndex",
    "PartitionPlan",
    "QueryEngine",
    "QueryError",
    "RepError",
    "ShardRoutingTable",
    "ShardedQueryEngine",
    "StagedUpdateError",
    "UpdateJournal",
    "build_bngraph",
    "build_engine",
    "build_index",
    "build_knn_index",
    "build_knn_tables",
    "build_sharded_engine",
    "delete_object",
    "indices_equivalent",
    "insert_object",
    "knn_index_cons_plus",
    "load_engine",
    "move_object",
    "pick_objects",
    "propose_starts",
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


def build_sharded_engine(
    graph: Graph | BNGraph,
    objects: np.ndarray,
    k: int,
    *,
    plan: PartitionPlan | str | None = None,
    shards: int | None = None,
    replication: dict[int, int] | None = None,
    device="cuda",
    use_kernel: bool = True,
) -> ShardedQueryEngine:
    """Road network -> vertex-sharded serving engine, S logical shards on one
    card.

    ``plan`` (a ``PartitionPlan`` or its spec string, ``"shards=4,ranges=auto"``
    say) names the whole layout: shard count, range boundaries (equal-width,
    explicit, or object-density ``auto``), replication and routing policy.
    The engine serves the scalar engine's results exactly under every layout.
    ``shards=`` and ``replication=`` are the legacy kwargs, turned into the
    equivalent plan (passing them beside ``plan`` raises
    ``EngineConfigError``); no plan and ``shards=None`` is one shard.
    """
    plan = PartitionPlan.resolve(plan, shards=shards, replication=replication)
    bn = graph if isinstance(graph, BNGraph) else build_bngraph(graph)
    return ShardedQueryEngine.build(bn, objects, k, plan=plan, device=device,
                                    use_kernel=use_kernel)


def load_engine(
    path,
    *,
    bn: BNGraph | None = None,
    plan: PartitionPlan | str | None = None,
    shards: int | None = None,
    replication: dict[int, int] | None = None,
    device="cuda",
    use_kernel: bool = True,
    journal=None,
) -> QueryEngine | ShardedQueryEngine:
    """Load a ``save`` / ``knn_build --out`` artifact (written by either
    package).

    A ``plan`` (or the legacy ``shards=`` / ``replication=``) that names a
    shard count, ranges or replication loads into a ``ShardedQueryEngine``
    under that layout whatever the writer's shard count (reshard-on-load:
    the artifact stores the logical vertex-order tables, plus any uneven
    boundaries and replication plan the writer served under, reused at the
    writer's shard count). No plan keeps the scalar engine.

    ``journal`` (a path or ``UpdateJournal``) attaches the write-ahead journal
    and replays whatever a killed process left in it (committed flush
    segments and the uncommitted tail), recovering the exact tables that
    process was serving. Requires ``bn`` when the journal is non-empty
    (replay runs real updates).
    """
    plan = PartitionPlan.resolve(plan, shards=shards, replication=replication)
    if plan.shards is not None or plan.ranges is not None or plan.replication is not None:
        return ShardedQueryEngine.load(path, bn=bn, plan=plan, device=device,
                                       use_kernel=use_kernel, journal=journal)
    return QueryEngine.load(path, bn=bn, device=device, use_kernel=use_kernel, journal=journal)


def stage_random_updates(engine: QueryEngine, mset: set, rng=None, count: int = 1) -> int:
    """Stage ``count`` random net object updates (the benchmark workload mix).

    Draws uniform vertices from ``[0, engine.n)`` (a sharded engine is driven
    identically: routing by owner happens at flush time): a present one is staged for
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
