"""The port's ``ShardedQueryEngine`` (S logical shards of one padded table, on
the CPU) held against the JAX package.

Tolerance: exact. The JAX package's own contract is that the sharded engine
equals the scalar engine bit for bit (``tests/core/test_sharded.py``,
``tests/core/test_halo.py``), so after EVERY flush the port's logical (n, k)
tables must be ``array_equal`` (int32 ids, float32 distances) to the JAX
scalar engine's on the same staged script, the flush stats dicts equal, and
query answers equal, at S in {1, 2, 3, 4, 8}, in both halo modes, under equal,
explicit uneven and ``auto`` ranges. The JAX sharded engine needs as many
devices as shards, and tier-1 JAX sees one, so the S = 4 comparison with it
(tables and ``stats()`` after each flush) runs in a subprocess with four
forced host devices.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import knn as jknn
from repro.core.bngraph import build_bngraph
from repro.core.engine import QueryEngine as JaxEngine
from repro.core.reference import knn_index_cons_plus as jax_cons_plus
from repro.core.sharded import ShardedQueryEngine as JaxSharded
from repro.graph.generators import pick_objects, random_connected_graph, road_network
from repro.kernels import ops as jops
from repro_torch import knn
from repro_torch.core.bngraph import bngraph_from_arrays
from repro_torch.core.errors import EngineConfigError, QueryError
from repro_torch.core.partition import PartitionPlan, propose_starts
from repro_torch.core.sharded import ShardedQueryEngine, expand_receivers, shard_tables
from repro_torch.kernels import ops
from repro_torch.launch import serve


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs many small tensor ops; under a parallel test
    run (several workers on a few cores) torch's intra-op thread pool makes
    each one wait on oversubscribed threads, 30x slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_bn(jbn):
    return bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})


def _setup(grid=12, mu=0.15, k=6, seed=0, plan="shards=1", halo="collective"):
    """(graph, objects, JAX BN-Graph, port BN-Graph, JAX scalar engine, port
    sharded engine) on the identical graph and tables."""
    g = road_network(grid, grid, seed=seed)
    objects = pick_objects(g.n, mu, seed=seed)
    jbn = build_bngraph(g)
    bn = _port_bn(jbn)
    je = JaxEngine.from_index(jax_cons_plus(jbn, objects, k), objects, bn=jbn)
    ids, d = (np.array(t) for t in je.tables)
    te = ShardedQueryEngine(ids, d, k, objects, bn=bn, plan=plan, device="cpu")
    te.halo = halo
    return g, objects, jbn, bn, je, te


def _tables_equal(je, te):
    ji, jd = je._host_tables()
    ti, td = te._host_tables()
    assert ti.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def _queries_equal(je, te, n, rng):
    us = np.concatenate([np.asarray(te.routing.starts), np.asarray(te.routing.starts) - 1,
                         rng.integers(0, n, 97), [-3, -1, n, n + 7]]).astype(np.int32)
    for ks in (None, rng.integers(1, je.k + 1, size=len(us)).astype(np.int32)):
        wi, wd = je.query_batch(us, ks)
        gi, gd = te.query_batch(us, ks)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def _mixed_script(engines, n, k, rng, steps=36, flush_every=8):
    """Staged moves / deletes / inserts through every engine, flushed every
    ``flush_every`` steps; yields after each flush (and once at the end)."""
    mset = set(np.asarray(engines[0].objects).tolist())
    for step in range(steps):
        u = int(rng.integers(0, n))
        outside = sorted(set(range(n)) - mset)
        r = rng.random()
        if r < 0.3 and outside and len(mset) > k + 1:
            src, dst = int(rng.choice(sorted(mset))), int(rng.choice(outside))
            for e in engines:
                e.stage_move(src, dst)
            mset.discard(src)
            mset.add(dst)
        elif u in mset and len(mset) > k + 1:
            for e in engines:
                e.stage_delete(u)
            mset.discard(u)
        elif u not in mset:
            for e in engines:
                e.stage_insert(u)
            mset.add(u)
        if step % flush_every == flush_every - 1:
            yield [e.flush_updates() for e in engines]
    yield [e.flush_updates() for e in engines]


def _uneven(n, shards):
    return tuple(int(s) for s in propose_starts(1.0 / (1.0 + np.arange(n, dtype=np.float64)),
                                                shards))


# ---------------------------------------------------------------------------
# the engine against the JAX scalar engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranges", ["equal", "uneven", "auto"])
@pytest.mark.parametrize("halo", ["collective", "host"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_flushes_match_jax_scalar_engine(shards, halo, ranges):
    rng = np.random.default_rng(7)
    plan = PartitionPlan(shards=shards, ranges=(_uneven(144, shards) if ranges == "uneven"
                                                else None if ranges == "equal" else "auto"))
    g, objects, jbn, bn, je, te = _setup(mu=0.2, plan=plan, halo=halo)
    assert te.num_shards == shards and te.stats()["uneven_ranges"] == (
        ranges != "equal" and shards > 1)
    _tables_equal(je, te)
    _queries_equal(je, te, g.n, rng)
    for want, got in _mixed_script([je, te], g.n, je.k, rng):
        assert got == want
        _tables_equal(je, te)
    _queries_equal(je, te, g.n, rng)
    s = te.stats()
    assert s["epoch"] == je.epoch and s["flushes"] == je.stats()["flushes"]
    assert s["halo"] == halo
    if shards > 1 and halo == "collective":
        assert s["halo_rounds_collective"] > 0 and s["halo_fallbacks"] == 0
    else:
        assert s["halo_rounds_collective"] == 0
    for key in ("repair_rounds_last", "frontier_rounds_last", "rows_repaired", "coalesced"):
        assert s[key] == je.stats()[key], key


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
    """The port engine test's random script on random topologies, at a shard
    count and halo mode drawn from the seed."""
    rng, n, extra, k, n_updates = _script_case(seed)
    g = random_connected_graph(n, extra_edges=extra, seed=seed)
    objects = set(pick_objects(n, 0.5, seed=seed).tolist())
    if len(objects) <= k + n_updates:
        objects |= set(range(min(n, k + n_updates + 2)))
    obj0 = np.array(sorted(objects))
    jbn = build_bngraph(g)
    je = JaxEngine.from_index(jax_cons_plus(jbn, obj0, k), obj0, bn=jbn)
    ids, d = (np.array(t) for t in je.tables)
    shards = min((2, 3, 4, 8)[seed % 4], n)
    te = ShardedQueryEngine(ids, d, k, obj0, bn=_port_bn(jbn), shards=shards, device="cpu")
    te.halo = ("collective", "host")[seed % 2]
    je.frontier = te.frontier = frontier
    for _ in range(n_updates):
        u = int(rng.integers(0, n))
        outside = [v for v in range(n) if v not in objects]
        if rng.random() < 0.35 and objects and outside:
            src, dst = int(rng.choice(sorted(objects))), int(rng.choice(outside))
            je.stage_move(src, dst)
            te.stage_move(src, dst)
            objects.discard(src)
            objects.add(dst)
        elif u in objects:
            if len(objects) <= k + 1:
                continue
            je.stage_delete(u)
            te.stage_delete(u)
            objects.discard(u)
        else:
            je.stage_insert(u)
            te.stage_insert(u)
            objects.add(u)
        if rng.random() < 0.3:
            assert te.flush_updates() == je.flush_updates()
            _tables_equal(je, te)
    assert te.flush_updates() == je.flush_updates()
    _tables_equal(je, te)
    fresh = knn.knn_index_cons_plus(_port_bn(jbn), np.array(sorted(objects)), k)
    assert knn.indices_equivalent(fresh, te.to_index())
    np.testing.assert_array_equal(te.objects, je.objects)


def test_device_frontier_matches_jax_scalar_frontier():
    """Boundary-crossing insert sources: the collective frontier returns the
    JAX scalar engine's affected rows, candidates and round count."""
    g, objects, jbn, bn, je, te = _setup(mu=0.2, plan="shards=4")
    outside = set(np.setdiff1d(np.arange(g.n), objects).tolist())
    starts = te.routing.starts
    srcs = sorted({int(v) for v in np.concatenate([starts, starts - 1]) if v in outside}
                  | set(sorted(outside)[::17][:3]))
    rows_j, ci_j, cd_j, rounds_j = je._insert_frontier(srcs)
    rows_t, ci_t, cd_t, rounds_t = te._insert_frontier(srcs)
    assert rounds_t == rounds_j
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(ci_t, ci_j)
    np.testing.assert_array_equal(cd_t, cd_j)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_device_expansion_matches_host_oracle(shards):
    g, objects, jbn, bn, je, te = _setup(plan=f"shards={shards}")
    rng = np.random.default_rng(7)
    te._nbr_tables()
    starts = te.routing.starts
    for _ in range(4):
        edges = np.concatenate([starts, starts - 1, [g.n - 1], rng.integers(0, g.n, 24)])
        active = np.unique(edges[(edges >= 0) & (edges < g.n)]).astype(np.int32)
        np.testing.assert_array_equal(te._expand_receivers_device(active),
                                      expand_receivers(te._nbr_indptr, te._nbr_indices, active))


def test_halo_overflow_falls_back_to_routed_path():
    g, objects, jbn, bn, je, te = _setup(plan="shards=2", seed=4)
    te.halo_capacity = 1  # below the 16-slot floor: every round overflows
    for _ in _mixed_script([je, te], g.n, je.k, np.random.default_rng(6), steps=16):
        _tables_equal(je, te)
    assert te.stats()["halo_fallbacks"] > 0
    assert te.stats()["halo_rounds_collective"] == 0


def test_collective_flush_never_calls_host_fetchers():
    g, objects, jbn, bn, je, te = _setup(plan="shards=2", seed=3)

    def boom(*a, **kw):
        raise AssertionError("routed host fetcher called on the collective path")

    te._fetch_rows = boom
    te._fetch_send = boom
    for _ in _mixed_script([je, te], g.n, je.k, np.random.default_rng(5), steps=24):
        _tables_equal(je, te)
    assert te.stats()["halo_rounds_collective"] > 0 and te.stats()["halo_fallbacks"] == 0


def test_flush_never_writes_a_published_epoch():
    g, objects, jbn, bn, je, te = _setup(plan="shards=3")
    te.keep_epochs = 3
    snaps = {te.epoch: [t.clone() for t in te._epochs.snapshot()]}
    for _ in _mixed_script([je, te], g.n, je.k, np.random.default_rng(2), steps=24):
        snaps[te.epoch] = [t.clone() for t in te._epochs.snapshot()]
        assert len(te.retained_epochs()) == min(3, len(snaps))
        for e in te.retained_epochs():
            assert all(torch.equal(a, b) for a, b in zip(te._epochs.snapshot(e), snaps[e]))


def test_shard_tables_layout_and_build():
    n, k = 10, 3
    ids = torch.arange((n + 1) * k, dtype=torch.int32).reshape(n + 1, k)
    ids[n] = -1
    d = torch.where(ids >= 0, ids.float(), float("inf"))
    s, r = 4, 3
    gi, gd = shard_tables(ids, d, n, s)
    assert gi.shape == (s * (r + 1), k)
    covered = set()
    for v in range(n):
        row = (v // r) * (r + 1) + v % r
        covered.add(row)
        assert torch.equal(gi[row], ids[v]) and torch.equal(gd[row], d[v])
    for row in set(range(s * (r + 1))) - covered:
        assert (gi[row] == -1).all() and torch.isinf(gd[row]).all()
    # the facade's build: the scalar build re-laid, for equal and auto ranges
    g = road_network(9, 9, seed=5)
    objects = pick_objects(g.n, 0.2, seed=5)
    bn = knn.build_bngraph(g)
    scalar = knn.build_engine(bn, objects, 4, device="cpu")
    for plan in ("shards=3", "shards=4,ranges=auto"):
        eng = knn.build_sharded_engine(bn, objects, 4, plan=plan, device="cpu")
        for mine, theirs in zip(eng._host_tables(), scalar._host_tables()):
            np.testing.assert_array_equal(mine, theirs)
    assert eng.stats()["uneven_ranges"] is True


def test_sharded_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    g = knn.road_network(6, 6, seed=0)
    objects = knn.pick_objects(g.n, 0.3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.build_sharded_engine(g, objects, 3, plan="shards=2")
    ids = np.full((g.n, 3), -1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedQueryEngine(ids, ids.astype(np.float32), 3, objects, shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.load_engine("unused.npz", plan="shards=2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "knn-index", "--grid", "6", "--k", "3", "--partition", "shards=2"])


def test_validation_is_typed():
    g, objects, jbn, bn, je, te = _setup(plan="shards=2")
    with pytest.raises(EngineConfigError):
        te.halo = "quantum"
    with pytest.raises(QueryError):
        te.query_batch(np.array([0, 1]), te.k + 1)
    te.stage_insert(int(np.setdiff1d(np.arange(g.n), objects)[0]))
    with pytest.raises(RuntimeError):  # ArtifactError: flush before save
        te.save("unused.npz")
    ids, d = (np.array(t) for t in je.tables)
    with pytest.raises(EngineConfigError):
        ShardedQueryEngine(ids, d, 6, objects, bn=bn, shards=g.n + 1, device="cpu")
    with pytest.raises(EngineConfigError):
        ShardedQueryEngine(ids, d, 6, objects, bn=bn, plan="ranges=0:5", shards=None,
                           device="cpu").stage_repartition([0, 1, 2])
    with pytest.raises(EngineConfigError):
        te.stage_repartition([5, 9])
    s = te.stats()
    padded = 2 * (te.shard_rows + 1)
    assert s["padded_rows"] == padded
    assert s["row_padding_overhead"] == round((padded - g.n) / g.n, 4)


# ---------------------------------------------------------------------------
# repartition-on-flush (the cases of tests/core/test_repartition.py)
# ---------------------------------------------------------------------------

PHASES = ["pre-repartition", "mid-repartition", "pre-swap"]


class SimulatedKill(Exception):
    pass


def _small(seed):
    g = knn.road_network(10, 10, seed=seed)
    objects = knn.pick_objects(g.n, 0.3, seed=seed)
    return g, knn.build_bngraph(g), objects, 4


@pytest.mark.parametrize("halo", ["collective", "host"])
def test_repartition_bit_identical_and_pins_old_epochs(halo):
    g, bn, objects, k = _small(0)
    eng = knn.build_sharded_engine(bn, objects, k, plan=PartitionPlan(shards=4), device="cpu")
    eng.halo = halo
    us = np.arange(g.n)
    before = [t.clone() for t in eng.query_batch(us)]
    e0 = eng.epoch
    starts = _uneven(g.n, 4)
    eng.repartition(starts)
    assert eng.epoch == e0 + 1 and eng.pending_repartition is None
    assert eng.routing.starts.tolist() == list(starts)
    assert all(torch.equal(a, b) for a, b in zip(before, eng.query_batch(us)))
    assert all(torch.equal(a, b) for a, b in zip(before, eng.query_batch(us, epoch=e0)))
    assert eng.routing.layout(e0).starts.tolist() != list(starts)
    s = eng.stats()
    assert s["uneven_ranges"] is True and s["repartitions"] == 1
    assert s["shard_starts"] == list(starts)
    # flushes after the repartition (churn at the moved boundaries too) still
    # equal the scalar engine's
    oracle = knn.build_engine(bn, objects, k, device="cpu")
    mset, oset = set(objects.tolist()), set(objects.tolist())
    for v in (starts[1] - 1, starts[1], starts[2]):
        for e, m in ((eng, mset), (oracle, oset)):
            (e.stage_delete if v in m else e.stage_insert)(v)
            (m.discard if v in m else m.add)(v)
    knn.stage_random_updates(eng, mset, rng=7, count=6)
    knn.stage_random_updates(oracle, oset, rng=7, count=6)
    assert eng.flush_updates() == oracle.flush_updates()
    for mine, theirs in zip(eng._host_tables(), oracle._host_tables()):
        np.testing.assert_array_equal(mine, theirs)


def test_repartition_roundtrip_save_load_both_packages(tmp_path):
    g, bn, objects, k = _small(1)
    eng = knn.build_sharded_engine(bn, objects, k, shards=4, device="cpu")
    eng.repartition(_uneven(g.n, 4))
    art = str(tmp_path / "uneven.npz")
    eng.save(art)
    us = np.arange(g.n)
    ref_ids, ref_d = (t.numpy() for t in eng.query_batch(us))
    same = knn.load_engine(art, bn=bn, plan=PartitionPlan(shards=4), device="cpu")
    assert same.routing.starts.tolist() == eng.routing.starts.tolist()
    assert same.stats()["uneven_ranges"] is True
    loaded = [same, knn.load_engine(art, bn=bn, device="cpu"),
              knn.load_engine(art, bn=bn, plan="shards=2", device="cpu"),
              knn.load_engine(art, bn=bn, plan="shards=1", device="cpu")]
    for other in loaded:
        ids, d = (t.numpy() for t in other.query_batch(us))
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(d, ref_d)
    # the JAX package reads the port's sharded artifact: scalar, and sharded
    # at the one shard its single CPU device seats
    jbn = jknn.build_bngraph(jknn.road_network(10, 10, seed=1))
    for jeng in (jknn.load_engine(art, bn=jbn), JaxSharded.load(art, bn=jbn, shards=1)):
        ids, d = (np.asarray(t) for t in jeng.query_batch(us))
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(d, ref_d)
    # staged updates on the reloaded uneven engine equal the scalar engine's
    scalar = loaded[1]
    mset, oset = set(objects.tolist()), set(objects.tolist())
    knn.stage_random_updates(same, mset, rng=3, count=6)
    knn.stage_random_updates(scalar, oset, rng=3, count=6)
    same.flush_updates()
    scalar.flush_updates()
    for mine, theirs in zip(same._host_tables(), scalar._host_tables()):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("phase", PHASES)
def test_kill_during_repartition_never_torn(phase):
    g, bn, objects, k = _small(2)
    eng = knn.build_sharded_engine(bn, objects, k, shards=4, device="cpu")
    twin = knn.build_sharded_engine(bn, objects, k, shards=4, device="cpu")
    us = np.arange(g.n)
    mset, tset = set(objects.tolist()), set(objects.tolist())
    knn.stage_random_updates(eng, mset, rng=5, count=5)
    knn.stage_random_updates(twin, tset, rng=5, count=5)
    starts = _uneven(g.n, 4)
    old = eng.routing.starts.copy()
    e0 = eng.epoch
    eng.stage_repartition(starts)

    def hook(e, ph):
        if ph == phase:
            raise SimulatedKill(ph)

    eng.checkpoint_hook = hook
    with pytest.raises(SimulatedKill):
        eng.flush_updates()
    eng.checkpoint_hook = None
    assert eng.routing.starts.tolist() == old.tolist() and eng.epoch == e0
    assert eng.pending_repartition.tolist() == list(starts)
    assert eng.stats()["flushes_failed"] == 1
    for a, b in zip(eng.query_batch(us), twin.query_batch(us)):
        assert torch.equal(a, b)
    twin.stage_repartition(starts)
    eng.flush_updates()
    twin.flush_updates()
    assert eng.epoch == twin.epoch and eng.pending_repartition is None
    assert eng.routing.starts.tolist() == list(starts)
    for mine, theirs in zip(eng._host_tables(), twin._host_tables()):
        np.testing.assert_array_equal(mine, theirs)


def test_stage_repartition_validation():
    g, bn, objects, k = _small(3)
    eng = knn.build_sharded_engine(bn, objects, k, shards=1, device="cpu")
    with pytest.raises(EngineConfigError):
        eng.stage_repartition([0, 50])
    with pytest.raises(EngineConfigError):
        eng.stage_repartition([5])
    assert eng.pending_repartition is None
    eng.stage_repartition([0])  # a no-op relayout stages, then clears
    eng.flush_updates()
    assert eng.pending_repartition is None and eng.stats()["repartitions"] == 0


# ---------------------------------------------------------------------------
# replicated hot shards (the cases of tests/core/test_replicas.py)
# ---------------------------------------------------------------------------


def _boundary_traffic(n, starts, rng):
    return np.concatenate([starts, np.maximum(starts - 1, 0), rng.integers(0, n, 128),
                           [-3, -1, n, n + 7]]).astype(np.int32)


@pytest.mark.parametrize("policy", ["round_robin", "least_outstanding"])
def test_replicated_serving_bit_identical(policy):
    g, objects, jbn, bn, je, te = _setup(plan="shards=4")
    te.set_replication({0: 3, 2: 1}, policy=policy)
    rng = np.random.default_rng(1)
    for us in (_boundary_traffic(g.n, te.routing.starts, rng),
               rng.integers(0, g.n, size=257).astype(np.int32)):
        for ks in (None, rng.integers(1, je.k + 1, size=len(us)).astype(np.int32)):
            wi, wd = je.query_batch(us, ks)
            gi, gd = te.query_batch(us, ks)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    s = te.stats()
    assert s["replica_batches"] == 4 and s["replica_queries"] > 0 and s["replica_errors"] == 0
    assert s["replica_slots"] == 8 and s["replica_policy"] == policy


def test_replica_buffers_byte_identical_every_epoch_and_pinned_reads():
    g, objects, jbn, bn, je, te = _setup(plan="shards=4")
    te.keep_epochs = 3
    te.set_replication({0: 2})
    us = _boundary_traffic(g.n, te.routing.starts, np.random.default_rng(2))
    e0 = te.epoch
    i0, d0 = (t.clone() for t in te.query_batch(us))
    mset = set(objects.tolist())
    for seed in (3, 4):
        knn.stage_random_updates(te, mset, rng=seed, count=4)
        te.flush_updates()
    te.repartition(_uneven(g.n, 4))  # a retained epoch under other boundaries
    assert len(te.retained_epochs()) == 3
    for epoch in te.retained_epochs():
        bufs = te.routing.replica_buffers(epoch)
        replicas = [(slot, b) for slot, b in bufs.items() if slot >= te.num_shards]
        assert len(replicas) == 2
        for _, (shard, _dev, ids, dists) in replicas:
            assert torch.equal(ids, bufs[shard][2]) and torch.equal(dists, bufs[shard][3])
    te.keep_epochs = 4
    te.set_replication({1: 1})
    mset = set(te.objects.tolist())
    knn.stage_random_updates(te, mset, rng=9, count=6)
    te.flush_updates()
    with pytest.raises(Exception):
        te.query_batch(us, epoch=e0)  # evicted by now
    ids_now, _ = te.query_batch(us)
    assert not torch.equal(ids_now, i0)
    e_pin = te.retained_epochs()[0]
    pi, pd = te.query_batch(us, epoch=e_pin)
    te.set_replication(None)
    qi, qd = te.query_batch(us, epoch=e_pin)
    assert torch.equal(pi, qi) and torch.equal(pd, qd)
    assert d0.shape == pd.shape


def test_replica_failure_degrades_to_primary_exactly():
    g, objects, jbn, bn, je, te = _setup(plan="shards=4")
    te.set_replication({0: 3})
    us = _boundary_traffic(g.n, te.routing.starts, np.random.default_rng(3))

    def boom(engine):
        engine.replica_fault_hook = None  # fail exactly one batch
        raise RuntimeError("simulated replica loss")

    te.replica_fault_hook = boom
    gi, gd = te.query_batch(us)
    wi, wd = je.query_batch(us)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    s = te.stats()
    assert s["replica_errors"] == 1 and "simulated replica loss" in s["last_replica_error"]
    gi2, _ = te.query_batch(us)
    np.testing.assert_array_equal(gi2.numpy(), np.asarray(wi))
    assert te.stats()["replica_batches"] == s["replica_batches"] + 1


def test_reshard_on_load_replication_plans(tmp_path):
    g, objects, jbn, bn, je, te = _setup(plan="shards=4")
    te.set_replication({0: 2})
    path = str(tmp_path / "rep.npz")
    te.save(path)
    us = np.random.default_rng(4).integers(0, g.n, size=129).astype(np.int32)
    want = np.asarray(je.query_batch(us)[0])
    same = ShardedQueryEngine.load(path, bn=bn, shards=4, device="cpu")
    assert same.routing.replication == {0: 2}
    np.testing.assert_array_equal(same.query_batch(us)[0].numpy(), want)
    assert same.stats()["replica_batches"] == 1
    assert ShardedQueryEngine.load(path, bn=bn, device="cpu").routing.replication == {0: 2}
    resharded = ShardedQueryEngine.load(path, bn=bn, shards=2, device="cpu")
    assert resharded.routing.replication == {}
    np.testing.assert_array_equal(resharded.query_batch(us)[0].numpy(), want)
    assert ShardedQueryEngine.load(path, bn=bn, shards=4, replication={},
                                   device="cpu").routing.replication == {}
    over = ShardedQueryEngine.load(path, bn=bn, shards=4, replication={1: 1}, device="cpu")
    assert over.routing.replication == {1: 1}
    np.testing.assert_array_equal(over.query_batch(us)[0].numpy(), want)


# ---------------------------------------------------------------------------
# artifacts across the packages, journals
# ---------------------------------------------------------------------------


def test_jax_artifacts_reshard_on_load_into_the_port(tmp_path):
    g, objects, jbn, bn, je, te = _setup(mu=0.2, plan="shards=1")
    mset = set(objects.tolist())
    jknn.stage_random_updates(je, mset, rng=2, count=8)
    je.flush_updates()
    scalar_art, sharded_art = str(tmp_path / "scalar.npz"), str(tmp_path / "sharded.npz")
    je.save(scalar_art)
    js = JaxSharded.load(scalar_art, bn=jbn, shards=1)
    js.save(sharded_art)
    for art in (scalar_art, sharded_art):
        for shards in (1, 3, 4):
            eng = knn.load_engine(art, bn=bn, plan=f"shards={shards}", device="cpu")
            assert isinstance(eng, ShardedQueryEngine) and eng.num_shards == shards
            _tables_equal(je, eng)
            np.testing.assert_array_equal(eng.objects, je.objects)
    # and onward: a flush on the resharded engine equals the JAX engine's
    mset2 = set(mset)
    knn.stage_random_updates(eng, mset, rng=5, count=6)
    jknn.stage_random_updates(je, mset2, rng=5, count=6)
    assert eng.flush_updates() == je.flush_updates()
    _tables_equal(je, eng)


def test_journal_recovery_on_the_sharded_engine(tmp_path):
    g, objects, jbn, bn, je, te = _setup(mu=0.2, plan="shards=3")
    art, wal = str(tmp_path / "a.npz"), str(tmp_path / "wal.bin")
    te.save(art)
    te.attach_journal(wal)
    mset = set(objects.tolist())
    knn.stage_random_updates(te, mset, rng=1, count=6)
    te.flush_updates()
    knn.stage_random_updates(te, mset, rng=2, count=6)  # the uncommitted tail
    rec = knn.load_engine(art, bn=bn, plan="shards=2", journal=wal, device="cpu")
    te.flush_updates()
    for mine, theirs in zip(rec._host_tables(), te._host_tables()):
        np.testing.assert_array_equal(mine, theirs)
    assert rec.epoch == 2


# ---------------------------------------------------------------------------
# the shard and halo ops, against the JAX package's block ops
# ---------------------------------------------------------------------------


def _padded_tables(rng, s, block, k, n):
    ids = rng.integers(-1, n, size=(s * block, k)).astype(np.int32)
    d = np.where(ids >= 0, rng.integers(0, 50, size=ids.shape), np.inf).astype(np.float32)
    ids[block - 1::block] = -1
    d[block - 1::block] = np.inf
    return ids, d


@pytest.mark.parametrize("s,b,p", [(1, 5, 3), (3, 4, 7), (4, 9, 1)])
def test_shard_rows_purge_merge_matches_jax_block_op(s, b, p):
    rng = np.random.default_rng(s * 10 + b)
    block, k, n = 8, 4, 30
    ids, d = _padded_tables(rng, s, block, k, n)
    rows = np.full((s, b), -1, np.int32)
    for sh in range(s):
        real = rng.choice(block - 1, size=min(b - 1, block - 1), replace=False)
        rows[sh, : len(real)] = sh * block + real
    dels = rng.choice(n, size=4, replace=False).astype(np.int32)
    ci = rng.integers(-1, n, size=(s, b, p)).astype(np.int32)
    cd = rng.integers(0, 50, size=(s, b, p)).astype(np.float32)
    ci[rows < 0] = -1
    t_ids, t_d = torch.from_numpy(ids.copy()), torch.from_numpy(d.copy())
    changed = ops.shard_rows_purge_merge(t_ids, t_d, torch.from_numpy(rows), block,
                                         torch.from_numpy(dels), torch.from_numpy(ci),
                                         torch.from_numpy(cd), k)
    for sh in range(s):
        blk = slice(sh * block, (sh + 1) * block)
        ji, jd, jch = jops.shard_rows_purge_merge(
            *(jnp.asarray(a) for a in (ids[blk], d[blk], rows[sh])), sh * block,
            *(jnp.asarray(a) for a in (dels, ci[sh], cd[sh])), k)
        np.testing.assert_array_equal(t_ids[blk].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(t_d[blk].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(changed[sh].numpy(), np.asarray(jch))
        hit = ops.shard_rows_containing(torch.from_numpy(ids), torch.from_numpy(dels), block)
        np.testing.assert_array_equal(
            hit[sh].numpy(),
            np.asarray(jops.shard_rows_containing(jnp.asarray(ids[blk]), jnp.asarray(dels))))
        gi, gd = ops.shard_gather_rows(torch.from_numpy(ids), torch.from_numpy(d),
                                       torch.from_numpy(rows), block)
        wi, wd = jops.shard_gather_rows(
            *(jnp.asarray(a) for a in (ids[blk], d[blk], rows[sh])), sh * block)
        np.testing.assert_array_equal(gi[sh].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd[sh].numpy(), np.asarray(wd))


def test_halo_ops_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(4):
        x = rng.integers(-3, 40, size=(int(rng.integers(1, 30)),)).astype(np.int32)
        np.testing.assert_array_equal(ops.masked_unique(torch.from_numpy(x)).numpy(),
                                      np.asarray(jops.masked_unique(jnp.asarray(x))))
        m, k, b, t, cols = int(rng.integers(1, 12)), 3, 7, 5, 6
        recv_ids = rng.integers(-1, 50, size=(m, k)).astype(np.int32)
        recv_d = np.where(recv_ids >= 0, rng.random((m, k)) * 9, np.inf).astype(np.float32)
        slot = rng.integers(0, m + 1, size=(b, t)).astype(np.int32)
        w = (rng.random((b, t)) * 3).astype(np.float32)
        mine = ops.halo_candidates(*(torch.from_numpy(a) for a in (recv_ids, recv_d, slot, w)), k)
        theirs = jops.halo_candidates(*(jnp.asarray(a) for a in (recv_ids, recv_d, slot, w)), k)
        for a, bb in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(bb))
        recv = np.where(rng.random((m, cols)) < 0.3, np.inf, rng.random((m, cols)) * 9)
        recv = recv.astype(np.float32)
        np.testing.assert_array_equal(
            ops.halo_fold_min(*(torch.from_numpy(a) for a in (recv, slot, w))).numpy(),
            np.asarray(jops.halo_fold_min(*(jnp.asarray(a) for a in (recv, slot, w)))))
        rows = rng.integers(-1, 20, size=(3, 4))
        np.testing.assert_array_equal(
            ops.shard_local_rows(8, torch.from_numpy(rows), 5).numpy(),
            np.asarray(jops.shard_local_rows(8, jnp.asarray(rows), 5)))


# ---------------------------------------------------------------------------
# the fleet loop and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,split", [(2, False), (1, True)])
def test_sharded_fleet_workload(steps, split):
    """Both new fleet parameters through the sharded engine: a two-street tick
    trace fused, and a one-street trace split into delete and insert flushes
    (split needs one street a tick: a vehicle's middle stop was never an
    object), land on the JAX scalar engine's tables."""
    from repro.workloads import drive_fleet_ticks as jax_drive
    from repro_torch.workloads import drive_fleet_ticks

    g = knn.road_network(10, 10, seed=4)
    jbn = jknn.build_bngraph(jknn.road_network(10, 10, seed=4))
    sim = knn.FleetSim(g, fleet_size=24, seed=4, steps_per_tick=steps)
    init = sim.positions.copy()
    trace = [sim.tick() for _ in range(4)]
    je = jknn.build_engine(jbn, init, 4)
    te = knn.build_sharded_engine(_port_bn(jbn), init, 4, plan="shards=4,ranges=auto",
                                  device="cpu")
    r_j = jax_drive(je, trace, batch=32, rng=np.random.default_rng(0), split=split)
    r_t = drive_fleet_ticks(te, trace, batch=32, rng=np.random.default_rng(0), split=split)
    assert (r_t["moves"], r_t["ticks"]) == (r_j["moves"], r_j["ticks"])
    assert te.epoch == je.epoch == (8 if split else 4)
    _tables_equal(je, te)
    np.testing.assert_array_equal(te.objects, sim.positions)


def test_serve_partition_cli_drift_resplit(capsys, monkeypatch):
    """The JAX test of the same name is red in the reference (its collective
    frontier does not trace under the installed JAX); here the drift detector
    must fire before and after the flip, the collective halo must serve every
    flush, and the engine's final tables must equal the host oracle's
    rebuild on its final object set."""
    built = []
    real = serve._build_knn_engine

    def capture(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(serve, "_build_knn_engine", capture)
    flip = 8
    out = serve.main(["--arch", "knn-index", "--smoke", "--grid", "10", "--k", "4",
                      "--batch", "128", "--ops", "2500", "--seed", "3", "--device", "cpu",
                      "--partition", "shards=4,ranges=auto", "--hot-shard", "0",
                      "--hot-frac", "0.9", "--hot-flip-round", str(flip)])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    resplits = out["repartition_rounds"]
    assert len(resplits) >= 2 and resplits[0] < flip and any(r >= flip for r in resplits)
    assert out["repartitioned_at_round"] == resplits[0] and out["errors"] == 0
    eng = out["engine"]
    assert eng["halo"] == "collective" and eng["halo_rounds_collective"] > 0
    assert eng["halo_fallbacks"] == 0 and eng["repartitions"] == len(resplits)
    assert out["partition"]["shards"] == 4 and out["partition"]["ranges"] == eng["shard_starts"]
    (engine,) = built
    g = knn.road_network(10, 10, seed=3)
    bn = knn.build_bngraph(g)
    assert knn.indices_equivalent(knn.knn_index_cons_plus(bn, engine.objects, 4),
                                  engine.to_index())
    jg = jknn.road_network(10, 10, seed=3)
    assert jknn.indices_equivalent(jax_cons_plus(jknn.build_bngraph(jg), engine.objects, 4),
                                   engine.to_index())


def test_serve_partition_cli_replicas_and_fleet(capsys):
    out = serve.main(["--arch", "knn-index", "--grid", "10", "--k", "4", "--batch", "64",
                      "--ops", "1200", "--device", "cpu", "--shards", "3",
                      "--replicate", "auto:2", "--hot-shard", "1", "--hot-frac", "0.8"])
    capsys.readouterr()
    assert out["replicated_shard"] == 1 and out["errors"] == 0
    assert out["engine"]["replication"] == {1: 2} and out["engine"]["replica_batches"] > 0
    assert out["partition"]["replication"] == {"1": 2}
    fleet = serve.main(["--arch", "knn-index", "--grid", "10", "--k", "4", "--device", "cpu",
                        "--workload", "fleet", "--fleet-size", "20", "--ticks", "3",
                        "--partition", "shards=2"])
    capsys.readouterr()
    assert fleet["engine"]["flushes"] == 3 and fleet["partition"]["shards"] == 2
    with pytest.raises(SystemExit):
        serve.main(["--arch", "knn-index", "--grid", "6", "--device", "cpu",
                    "--partition", "shards=2", "--shards", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "knn-index", "--grid", "6", "--device", "cpu",
                    "--hot-frac", "0.5"])


# ---------------------------------------------------------------------------
# against the JAX sharded engine itself, at S = 4 (four forced host devices)
# ---------------------------------------------------------------------------

_JAX_S4 = r'''
import dataclasses, json, os, sys, tempfile
import numpy as np
import torch
from repro import knn as jknn
from repro.core.partition import propose_starts
from repro.core.reference import knn_index_cons_plus
from repro.core.sharded import ShardedQueryEngine as JS
from repro.graph.generators import pick_objects, road_network
from repro_torch import knn
from repro_torch.core.bngraph import bngraph_from_arrays
from repro_torch.core.sharded import ShardedQueryEngine as TS

torch.set_num_threads(1)  # as the in-process tests: small ops, a loaded host
KEYS = ("halo_rounds_collective", "halo_fallbacks", "shard_starts", "row_padding_overhead",
        "repartitions", "padded_rows", "shard_rows", "range_rows", "uneven_ranges",
        "num_shards", "epoch", "flushes", "repair_rounds_last", "frontier_rounds_last",
        "rows_repaired", "coalesced", "epoch_table_bytes", "halo", "replica_slots")
g = road_network(12, 12, seed=2)
objects = pick_objects(g.n, 0.15, seed=2)
jbn = jknn.build_bngraph(g)
bn = bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})
k = 6
idx = knn_index_cons_plus(jbn, objects, k)
skew = propose_starts(1.0 / (1.0 + np.arange(g.n)), 4)
report = []
# the JAX engine's collective frontier (fhalo) does not trace under every JAX
# release, so its collective cases run the host checkIns pipeline, or a
# capacity under which every collective frontier round falls back
for halo, frontier, cap in (("host", "device", 4096), ("collective", "host", 4096),
                            ("collective", "device", 1)):
    je = JS.from_index(idx, objects, bn=jbn, shards=4)
    te = TS.from_index(idx, objects, bn=bn, shards=4, device="cpu")
    for e in (je, te):
        e.halo, e.frontier, e.halo_capacity = halo, frontier, cap
    rng = np.random.default_rng(11)
    mset = set(objects.tolist())
    flushes = 0
    for step in range(30):
        u = int(rng.integers(0, g.n))
        if u in mset:
            if len(mset) <= k + 1:
                continue
            je.stage_delete(u); te.stage_delete(u); mset.discard(u)
        else:
            je.stage_insert(u); te.stage_insert(u); mset.add(u)
        if step % 7 == 6 or step == 29:
            if step == 20:
                je.stage_repartition(skew); te.stage_repartition(skew)
            assert je.flush_updates() == te.flush_updates()
            flushes += 1
            a, b = je._host_tables(), te._host_tables()
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), (halo, step)
            js, ts = je.stats(), te.stats()
            bad = {key: (js[key], ts[key]) for key in KEYS if js[key] != ts[key]}
            assert not bad, (halo, frontier, step, bad)
    report.append({"halo": halo, "frontier": frontier, "cap": cap, "flushes": flushes,
                   **{key: ts[key] for key in ("halo_rounds_collective", "halo_fallbacks",
                                               "repartitions")}})
# reshard-on-load between the packages at S = 4, uneven boundaries kept
tmp = tempfile.mkdtemp()
jart, tart = os.path.join(tmp, "j.npz"), os.path.join(tmp, "t.npz")
je.save(jart)
te.save(tart)
us = np.arange(g.n)
want = [np.asarray(x) for x in je.query_batch(us)]
for path in (jart, tart):
    for eng in (TS.load(path, bn=bn, device="cpu"), TS.load(path, bn=bn, shards=2, device="cpu"),
                JS.load(path, bn=jbn), JS.load(path, bn=jbn, shards=2)):
        got = [np.asarray(x) for x in eng.query_batch(us)]
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
        if eng.num_shards == 4:
            assert eng.routing.starts.tolist() == skew.tolist()
print(json.dumps(report))
'''


def test_matches_jax_sharded_engine_at_four_shards(devices_subprocess):
    report = json.loads(devices_subprocess(_JAX_S4, n_devices=4).strip().splitlines()[-1])
    assert [r["flushes"] for r in report] == [5, 5, 5]
    host, coll, capped = report
    assert host["halo_rounds_collective"] == 0 and host["repartitions"] == 1
    assert coll["halo_rounds_collective"] > 0 and coll["halo_fallbacks"] == 0
    assert capped["halo_rounds_collective"] == 0 and capped["halo_fallbacks"] > 0
