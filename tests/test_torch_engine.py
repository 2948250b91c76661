"""The port's ``QueryEngine`` (on the CPU) held against the JAX package's.

State is carried across, not rebuilt: the BN-Graph through
``bngraph_from_arrays`` and the tables through ``QueryEngine.from_tables``, so
both engines start from the identical graph and tables and then replay the
same staged script. Tolerance: exact. After EVERY flush the two engines'
tables must be ``array_equal`` (int32 ids, float32 distances; the pipeline
only adds one float32 weight to one float32 distance and takes mins), the
flush stats dicts equal, and at the end both ``indices_equivalent`` (atol
1e-9) to the float64 host oracle's rebuild on the final object set.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.bngraph import build_bngraph
from repro.core.engine import QueryEngine as JaxEngine
from repro.core.reference import knn_index_cons_plus as jax_cons_plus
from repro.graph.generators import pick_objects, random_connected_graph, road_network
from repro_torch.core.bngraph import bngraph_from_arrays
from repro_torch.core.engine import EpochStore, QueryEngine
from repro_torch.core.errors import (
    EngineConfigError,
    EpochError,
    QueryError,
    RepError,
    StagedUpdateError,
)
from repro_torch.core.index import indices_equivalent
from repro_torch.core.reference import knn_index_cons_plus
from repro_torch.core.updates import delete_object, insert_object, move_object


def _pair(g, objects, k, frontier="device"):
    """(jax engine, torch engine, port BN-Graph) on identical graph + tables."""
    jbn = build_bngraph(g)
    bn = bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})
    idx = jax_cons_plus(jbn, objects, k)
    je = JaxEngine.from_index(idx, objects, bn=jbn)
    ids, d = (np.asarray(t) for t in je.tables)
    te = QueryEngine.from_tables(ids, d, k, objects, bn=bn, device="cpu")
    je.frontier = te.frontier = frontier
    return je, te, bn


def _tables_equal(je, te):
    ji, jd = (np.asarray(t) for t in je.tables)
    ti, td = (t.numpy() for t in te.tables)
    assert ti.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def _road_engine(grid=8, mu=0.2, k=4, seed=0):
    g = road_network(grid, grid, seed=seed)
    objects = pick_objects(g.n, mu, seed=seed)
    je, te, bn = _pair(g, objects, k)
    return g, objects, je, te, bn


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def test_from_tables_accepts_both_layouts_and_copies():
    g, objects, je, te, bn = _road_engine()
    ids, d = (np.asarray(t) for t in je.tables)  # (n+1, k)
    short = QueryEngine.from_tables(ids[:-1], d[:-1], 4, objects, bn=bn, device="cpu")
    _tables_equal(je, short)
    keep = ids.copy()
    te.tables[0][0, 0] = 12345  # the engine's copy, not the caller's array
    np.testing.assert_array_equal(ids, keep)
    with pytest.raises(ValueError):
        QueryEngine.from_tables(ids[:, :3], d[:, :3], 4, objects, bn=bn, device="cpu")
    with pytest.raises(ValueError):
        QueryEngine.from_tables(ids[:5], d[:5], 4, objects, bn=bn, device="cpu")


@pytest.mark.parametrize("k_arg", [None, 2, "per-query"])
def test_query_batch_matches_jax(k_arg):
    g, objects, je, te, _ = _road_engine()
    rng = np.random.default_rng(3)
    us = rng.integers(0, g.n, size=77).astype(np.int32)
    k = rng.integers(0, 5, size=77).astype(np.int32) if k_arg == "per-query" else k_arg
    want = je.query_batch(us, k)
    got = te.query_batch(us, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert te.stats()["queries_served"] == 77 and te.stats()["last_batch_size"] == 77


def test_query_batch_matches_scalar_index_query():
    g, objects, _, te, bn = _road_engine()
    idx = te.to_index()
    via_index = QueryEngine.from_index(idx, objects, bn=bn, device="cpu")
    assert torch.equal(via_index.tables[0], te.tables[0])
    assert torch.equal(via_index.tables[1], te.tables[1])
    ids, d = te.query_batch(np.arange(g.n))
    for u in range(g.n):
        row = [(int(i), float(x)) for i, x in zip(ids[u].tolist(), d[u].tolist()) if i >= 0]
        assert row == idx.query(u)


def test_query_errors_are_typed():
    g, objects, _, te, _ = _road_engine()
    with pytest.raises(QueryError):
        te.query_batch(np.arange(4), 5)  # index k is 4
    with pytest.raises(QueryError):
        te.query_batch(np.arange(4), np.array([1, 2, 9, 1]))
    with pytest.raises(QueryError):
        te.query_batch(np.arange(4), np.array([1, 2]))
    with pytest.raises(QueryError):
        te.query_batch(np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError):  # the seed contract: QueryError is a ValueError
        te.query_batch(np.arange(4), 5)
    assert issubclass(QueryError, RepError) and issubclass(EpochError, RepError)


def test_query_progressive_batch_prefixes():
    g, objects, _, te, _ = _road_engine()
    us = np.arange(10)
    full_i, full_d = te.query_batch(us)
    steps = list(te.query_progressive_batch(us))
    assert len(steps) == te.k
    for i, (pi, pd) in enumerate(steps, start=1):
        assert torch.equal(pi, full_i[:, :i]) and torch.equal(pd, full_d[:, :i])


# ---------------------------------------------------------------------------
# the staged-script property, side by side with the JAX engine
# ---------------------------------------------------------------------------


def _script_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 41))
    extra = int(rng.integers(0, 41))
    k = int(rng.integers(1, 6))
    n_updates = int(rng.integers(1, 13))
    return rng, n, extra, k, n_updates


@pytest.mark.parametrize("frontier", ["device", "host"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_staged_script_matches_jax_engine_after_every_flush(seed, frontier):
    rng, n, extra, k, n_updates = _script_case(seed)
    g = random_connected_graph(n, extra_edges=extra, seed=seed)
    objects = set(pick_objects(n, 0.5, seed=seed).tolist())
    if len(objects) <= k + n_updates:  # keep |M| > k through deletions
        objects |= set(range(min(n, k + n_updates + 2)))
    obj0 = np.array(sorted(objects))
    je, te, bn = _pair(g, obj0, k, frontier)
    _tables_equal(je, te)
    idx = knn_index_cons_plus(bn, obj0, k)  # the scalar host oracle, port's copy
    flushes = 0
    for _ in range(n_updates):
        u = int(rng.integers(0, n))
        r = rng.random()
        outside = [v for v in range(n) if v not in objects]
        if r < 0.35 and objects and outside:
            src = int(rng.choice(sorted(objects)))
            dst = int(rng.choice(outside))
            move_object(bn, idx, src, dst)
            je.stage_move(src, dst)
            te.stage_move(src, dst)
            objects.discard(src)
            objects.add(dst)
        elif u in objects:
            if len(objects) <= k + 1:
                continue
            delete_object(bn, idx, u)
            je.stage_delete(u)
            te.stage_delete(u)
            objects.discard(u)
        else:
            insert_object(bn, idx, u)
            je.stage_insert(u)
            te.stage_insert(u)
            objects.add(u)
        if rng.random() < 0.3:  # flush at random interleaving points
            assert te.flush_updates() == je.flush_updates()
            _tables_equal(je, te)
            flushes += 1
    assert te.flush_updates() == je.flush_updates()
    _tables_equal(je, te)
    assert te.epoch == je.epoch == flushes + 1
    fresh = knn_index_cons_plus(bn, np.array(sorted(objects)), k)
    assert indices_equivalent(fresh, idx)
    assert indices_equivalent(fresh, te.to_index())
    np.testing.assert_array_equal(te.objects, je.objects)
    ts, js = te.stats(), je.stats()
    for key in ("flushes", "inserts_applied", "deletes_applied", "moves_applied",
                "coalesced", "rows_repaired", "repair_rounds_last", "frontier_rounds_last"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_road_flushes_match_jax_engine(seed):
    """Bigger batches on a road grid: several inserts, deletes and moves per
    flush, so the frontier runs multi-column and the repair multi-round."""
    g = road_network(12, 12, seed=seed)
    objects = pick_objects(g.n, 0.15, seed=seed)
    je, te, bn = _pair(g, objects, 5)
    rng = np.random.default_rng(seed)
    mset = set(objects.tolist())
    for _ in range(3):
        present = rng.choice(sorted(mset), size=8, replace=False).tolist()
        absent = [v for v in rng.permutation(g.n).tolist() if v not in mset][:10]
        for u in present[:4]:
            je.stage_delete(u), te.stage_delete(u)
            mset.discard(u)
        for v in absent[:6]:
            je.stage_insert(v), te.stage_insert(v)
            mset.add(v)
        for u, v in zip(present[4:], absent[6:]):
            je.stage_move(u, v), te.stage_move(u, v)
            mset.discard(u)
            mset.add(v)
        assert te.flush_updates() == je.flush_updates()
        _tables_equal(je, te)
    fresh = knn_index_cons_plus(bn, np.array(sorted(mset)), 5)
    assert indices_equivalent(fresh, te.to_index())


def test_coalescing_rules_and_stats():
    g, objects, je, te, _ = _road_engine()
    mset = set(objects.tolist())
    absent = [v for v in range(g.n) if v not in mset]
    a, b, c = absent[:3]
    o = sorted(mset)[0]
    for e in (je, te):
        e.stage_insert(a)
        e.stage_delete(a)          # insert then delete: nothing
        e.stage_delete(o)
        e.stage_insert(o)          # delete then insert: nothing
        e.stage_move(sorted(mset)[1], b)
        e.stage_move(b, c)         # chain collapses to its endpoint
    assert te.queue_depth == 6
    res = te.flush_updates()
    assert res == je.flush_updates()
    assert (res["inserts"], res["deletes"], res["moves"], res["coalesced"]) == (0, 0, 1, 5)
    _tables_equal(je, te)


def test_stage_validation_is_typed():
    g, objects, _, te, _ = _road_engine()
    o = int(objects[0])
    absent = next(v for v in range(g.n) if v not in set(objects.tolist()))
    with pytest.raises(StagedUpdateError):
        te.stage_insert(o)
    with pytest.raises(StagedUpdateError):
        te.stage_delete(absent)
    with pytest.raises(StagedUpdateError):
        te.stage_move(o, o)
    with pytest.raises(StagedUpdateError):
        te.stage_move(absent, o)
    with pytest.raises(StagedUpdateError):
        te.stage_insert(g.n)
    with pytest.raises(EngineConfigError):
        te.frontier = "gpu"
    ids, d = te.tables
    no_bn = QueryEngine.from_tables(ids.numpy(), d.numpy(), te.k, objects, device="cpu")
    with pytest.raises(RuntimeError, match="BN-Graph"):
        no_bn.stage_insert(absent)


# ---------------------------------------------------------------------------
# epochs: mutable tensors must not leak into published snapshots
# ---------------------------------------------------------------------------


def _stage_mix(eng, mset, seed, count=5):
    from repro_torch import knn

    knn.stage_random_updates(eng, mset, rng=seed, count=count)
    u = sorted(mset)[0]
    v = next(w for w in range(eng.n) if w not in mset)
    eng.stage_move(u, v)
    mset.discard(u)
    mset.add(v)


def test_queries_never_observe_mid_flush_state():
    g, objects, _, te, _ = _road_engine()
    mset = set(int(o) for o in objects)
    us = np.arange(g.n, dtype=np.int32)
    before = tuple(t.clone() for t in te.query_batch(us))
    seen: dict[str, tuple] = {}

    def probe(e, phase):
        ids, d = e.query_batch(us)
        seen.setdefault(phase, (ids.clone(), d.clone()))

    te.checkpoint_hook = probe
    _stage_mix(te, mset, seed=7)  # move included, so repair rounds run
    te.flush_updates()
    te.checkpoint_hook = None
    after = te.query_batch(us)
    assert not (torch.equal(before[0], after[0]) and torch.equal(before[1], after[1]))
    for phase in ("mid-repair-round", "pre-swap", "post-swap"):
        assert phase in seen, f"phase {phase} never fired"
        want = after if phase == "post-swap" else before
        assert torch.equal(seen[phase][0], want[0]), f"{phase}: ids tore"
        assert torch.equal(seen[phase][1], want[1]), f"{phase}: dists tore"


def test_epoch_pinned_query_survives_flush_and_failed_flush():
    """A query pinned to epoch e returns the same tiles after a flush and
    after a failed flush; the failed flush leaves queue and tables intact."""
    g, objects, _, te, _ = _road_engine()
    te.keep_epochs = 3
    mset = set(int(o) for o in objects)
    us = np.arange(g.n, dtype=np.int32)
    e0 = tuple(t.clone() for t in te.query_batch(us, epoch=0))
    held = te.query_batch(us)  # a reader still holding epoch-0 result tiles
    snap0 = te._epochs.snapshot(0)

    _stage_mix(te, mset, seed=1)
    te.flush_updates()
    assert te.epoch == 1
    pinned = te.query_batch(us, epoch=0)
    assert torch.equal(pinned[0], e0[0]) and torch.equal(pinned[1], e0[1])
    assert torch.equal(held[0], e0[0]) and torch.equal(held[1], e0[1])
    assert te._epochs.snapshot(0)[0] is snap0[0]  # the very tensors, never written
    e1 = tuple(t.clone() for t in te.query_batch(us))
    assert not torch.equal(e1[0], e0[0])

    class Kill(RuntimeError):
        pass

    def die(e, phase):
        if phase == "pre-swap":
            raise Kill(phase)

    _stage_mix(te, mset, seed=2)
    depth = te.queue_depth
    te.checkpoint_hook = die
    with pytest.raises(Kill):
        te.flush_updates()
    te.checkpoint_hook = None
    assert te.epoch == 1 and te.queue_depth == depth
    assert te.stats()["flushes_failed"] == 1
    now = te.query_batch(us)
    assert torch.equal(now[0], e1[0]) and torch.equal(now[1], e1[1])
    assert torch.equal(te.tables[0], te._epochs.snapshot()[0])
    again = te.query_batch(us, epoch=0)
    assert torch.equal(again[0], e0[0]) and torch.equal(again[1], e0[1])

    te.flush_updates()  # the retry lands
    assert te.epoch == 2 and te.queue_depth == 0
    fresh = knn_index_cons_plus(te.bn, np.array(sorted(mset)), te.k)
    assert indices_equivalent(fresh, te.to_index())
    still = te.query_batch(us, epoch=1)
    assert torch.equal(still[0], e1[0]) and torch.equal(still[1], e1[1])


def test_epoch_retention_and_eviction():
    g, objects, _, te, _ = _road_engine()
    mset = set(int(o) for o in objects)
    assert te.retained_epochs() == [0] and te.keep_epochs == 2
    for seed in (1, 2, 3):
        _stage_mix(te, mset, seed=seed)
        te.flush_updates()
    assert te.retained_epochs() == [2, 3]
    with pytest.raises(EpochError):
        te.query_batch(np.arange(3), epoch=0)
    assert te.epoch_stats()["origin"] == "flush"
    with pytest.raises(EpochError):
        te.epoch_stats(0)
    te.keep_epochs = 1
    assert te.retained_epochs() == [3]
    with pytest.raises(EpochError):
        te.keep_epochs = 0
    assert te.stats()["epoch_table_bytes"] == (g.n + 1) * te.k * 8
    store = EpochStore(keep=2)
    assert store.current == -1


def test_mid_repair_failure_rolls_back_whole():
    g, objects, _, te, _ = _road_engine()
    mset = set(int(o) for o in objects)
    before = tuple(t.clone() for t in te.tables)

    def die(e, phase):
        if phase == "mid-repair-round":
            raise KeyboardInterrupt  # BaseException: the rollback must still run

    _stage_mix(te, mset, seed=4)
    te.checkpoint_hook = die
    with pytest.raises(KeyboardInterrupt):
        te.flush_updates()
    te.checkpoint_hook = None
    assert torch.equal(te.tables[0], before[0]) and torch.equal(te.tables[1], before[1])
    te.flush_updates()
    fresh = knn_index_cons_plus(te.bn, np.array(sorted(mset)), te.k)
    assert indices_equivalent(fresh, te.to_index())
