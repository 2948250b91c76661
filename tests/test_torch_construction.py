"""The port's construction (``repro_torch.core.construct``, on the CPU) held
against the JAX package's ``build_knn_tables_jax(use_pallas=False)``:
``array_equal`` on both (n+1, k) tables, int32 ids and float32 distances
(tolerance exact: one float32 add and mins, no summation order), and against
the float64 host oracle ``knn_index_cons_plus`` via ``indices_equivalent``
(atol 1e-9, integer edge weights). The BN-Graph is built once by the JAX
package and carried across with ``bngraph_from_arrays``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bngraph import build_bngraph
from repro.core.construct_jax import build_knn_tables_jax
from repro.core.construct_jax import prepare_sweep as jax_prepare_sweep
from repro.kernels import ops as jops
from repro.graph.generators import pick_objects, random_connected_graph, road_network
from repro_torch.core import construct
from repro_torch.core.bngraph import BNGraph, bngraph_from_arrays
from repro_torch.core.bngraph import build_bngraph as port_build_bngraph
from repro_torch.core.index import indices_equivalent
from repro_torch.core.reference import knn_index_cons_plus
from repro_torch.graph import generators as port_generators


def carry_bn(jbn) -> BNGraph:
    return bngraph_from_arrays(**{f.name: getattr(jbn, f.name) for f in dataclasses.fields(jbn)})


def _graph(kind, a, b, seed):
    if kind == "road":
        return road_network(a, b, seed=seed)
    return random_connected_graph(a, extra_edges=b, seed=seed)


CASES = [
    ("road", 10, 10, 5, 0.2, 6),
    ("road", 12, 12, 1, 0.1, 7),
    ("road", 9, 9, 2, 0.3, 5),
    ("road", 11, 13, 7, 0.2, 4),
    ("rand", 5, 0, 3, 1.0, 2),
    ("rand", 23, 30, 11, 0.5, 3),
    ("rand", 40, 60, 42, 0.2, 7),
    ("rand", 31, 4, 9, 0.8, 1),
]


@pytest.mark.parametrize("kind,a,b,seed,mu,k", CASES)
def test_build_knn_tables_matches_jax_and_oracle(kind, a, b, seed, mu, k):
    g = _graph(kind, a, b, seed)
    objects = pick_objects(g.n, mu, seed=seed)
    jbn = build_bngraph(g)
    bn = carry_bn(jbn)
    want_ids, want_d = build_knn_tables_jax(jbn, objects, k, use_pallas=False)
    got_ids, got_d = construct.build_knn_tables(bn, objects, k, device="cpu")
    assert got_ids.dtype == torch.int32 and got_d.dtype == torch.float32
    assert tuple(got_ids.shape) == (g.n + 1, k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    q = torch.arange(0, g.n, 3, dtype=torch.int32)
    rows_i, rows_d = construct.batched_query(got_ids, got_d, q)
    assert torch.equal(rows_i, got_ids[::3][: len(q)]) and torch.equal(rows_d, got_d[::3][: len(q)])
    oracle = knn_index_cons_plus(bn, objects, k)
    assert indices_equivalent(oracle, construct.tables_to_index(got_ids, got_d, g.n, k))
    assert indices_equivalent(oracle, construct.build_knn_index(bn, objects, k, device="cpu"))


def test_build_matches_pallas_interpret_build():
    g = road_network(8, 8, seed=5)
    objects = pick_objects(g.n, 0.2, seed=5)
    jbn = build_bngraph(g)
    want_ids, want_d = build_knn_tables_jax(jbn, objects, 4, use_pallas=True)
    got_ids, got_d = construct.build_knn_tables(carry_bn(jbn), objects, 4, device="cpu")
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("direction", ["up", "down"])
def test_sweep_plan_layout_matches_jax(direction):
    g = road_network(12, 12, seed=1)
    jbn = build_bngraph(g)
    want = jax_prepare_sweep(jbn, direction)
    plan = construct.prepare_sweep(carry_bn(jbn), direction, device="cpu")
    assert plan.level_sizes == want.level_sizes and sum(plan.level_sizes) == g.n
    assert plan.num_levels == want.num_levels
    # same neighbour widths; the reference also splits each width by row-chunk tier
    assert plan.bucket_signature() == tuple(dict.fromkeys(t for t, _ in want.bucket_signature()))
    assert plan.occupancy_levelwise == want.occupancy_levelwise
    cells = sum(size * plan.buckets[bid].t_pad for bid, _, size in plan.levels.tolist())
    live = sum(int((b.nbr >= 0).sum()) for b in plan.buckets)
    assert plan.occupancy == live / cells and plan.occupancy >= want.occupancy
    # every vertex carries the reference's schedule row, at the reference's width;
    # the reference's padded rows (verts == n) have no counterpart here

    def by_vertex(buckets):
        out = {}
        for b in buckets:
            verts, nbr, w = (np.asarray(x) for x in (b.verts, b.nbr, b.w))
            for i in np.flatnonzero(verts < g.n):
                out[int(verts[i])] = (b.t_pad, nbr[i].tolist(), w[i].tolist())
        return out

    mine, theirs = by_vertex(plan.buckets), by_vertex(want.buckets)
    assert mine == theirs and len(mine) == g.n
    assert sum(int(b.verts.numel()) for b in plan.buckets) == g.n
    # every level names a contiguous in-bucket row range holding its vertices
    seen = []
    for bid, off, size in plan.levels.tolist():
        verts = plan.buckets[bid].verts[off : off + size].numpy()
        assert (verts < g.n).all()
        seen.extend(verts.tolist())
    assert sorted(seen) == list(range(g.n))


def test_own_copies_of_the_host_modules_agree_with_the_reference_package():
    """The port keeps its own graph generator and BN-Graph construction; the same
    seed must give the same network and the same BN-Graph."""
    g = road_network(10, 11, seed=3)
    pg = port_generators.road_network(10, 11, seed=3)
    for name in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(g, name), getattr(pg, name))
    np.testing.assert_array_equal(
        pick_objects(g.n, 0.1, seed=3), port_generators.pick_objects(pg.n, 0.1, seed=3))
    jbn, pbn = build_bngraph(g), port_build_bngraph(pg)
    for f in dataclasses.fields(jbn):
        np.testing.assert_array_equal(getattr(jbn, f.name), getattr(pbn, f.name))


def test_bngraph_from_arrays_needs_every_field():
    with pytest.raises(ValueError, match="missing"):
        bngraph_from_arrays(n=3)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    g = road_network(6, 6, seed=0)
    bn = carry_bn(build_bngraph(g))
    objects = pick_objects(g.n, 0.3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        construct.build_knn_tables(bn, objects, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        construct.prepare_sweep(bn, "up")


@pytest.mark.parametrize("direction", ["up", "down"])
def test_level_table_covers_every_level_once_in_order(direction):
    """The device level table run_sweep hands to the one-launch sweep: one
    (bucket, first row, rows) entry per level, in level order; within a
    bucket its levels' row ranges follow each other and cover it once."""
    bn = carry_bn(build_bngraph(road_network(12, 12, seed=1)))
    plan = construct.prepare_sweep(bn, direction, device="cpu")
    assert plan.levels.dtype == torch.int32 and tuple(plan.levels.shape) == (plan.num_levels, 3)
    assert [size for _, _, size in plan.levels.tolist()] == list(plan.level_sizes)
    next_row = [0] * len(plan.buckets)
    for bid, off, size in plan.levels.tolist():
        assert off == next_row[bid] and size > 0
        next_row[bid] += size
    assert next_row == [int(b.verts.numel()) for b in plan.buckets]
    # every vertex once, in the reference's level order
    order = np.concatenate([plan.buckets[bid].verts[off : off + size].numpy()
                            for bid, off, size in plan.levels.tolist()])
    np.testing.assert_array_equal(order, np.concatenate(bn.level_members(direction)))


def test_run_sweep_walks_the_level_table():
    """The one call follows plan.levels: cut the table's last level and that
    level's rows are never written."""
    g = road_network(9, 9, seed=2)
    objects = pick_objects(g.n, 0.3, seed=2)
    bn = carry_bn(build_bngraph(g))
    plan = construct.prepare_sweep(bn, "up", device="cpu")
    ex_ids, ex_d = construct.object_extras(bn.n, objects, 4, device="cpu")
    full = construct.run_sweep(plan, ex_ids, ex_d, 4)
    cut = construct.run_sweep(dataclasses.replace(plan, levels=plan.levels[:-1]), ex_ids, ex_d, 4)
    bid, off, size = plan.levels[-1].tolist()
    last = plan.buckets[bid].verts[off : off + size].long()
    assert (cut[0][last] == -1).all() and (full[0][last] >= 0).any()
    keep = torch.ones(bn.n + 1, dtype=torch.bool)
    keep[last] = False
    assert torch.equal(cut[0][keep], full[0][keep]) and torch.equal(cut[1][keep], full[1][keep])


@pytest.mark.parametrize("seed", [0, 1])
def test_many_level_sweep_matches_the_jax_level_loop(seed):
    """A synthetic sweep of 40 levels of varied size and width (rows read
    rows of earlier levels, mostly the one before), packed by pack_sweep and
    run in one call, against the JAX package's sweep_merge applied level by
    level."""
    rng = np.random.default_rng(seed)
    n, k = 700, 5
    perm = rng.permutation(n).astype(np.int32)
    sizes = rng.integers(1, 30, size=40)
    levels, done, at = [], np.empty(0, np.int32), 0
    for size in sizes:
        verts = perm[at : at + size]
        at += size
        width = int(rng.choice([1, 3, 6, 17, 40]))
        nbr = np.full((size, width), -1, np.int32)
        if done.size:
            recent = done[-60:]
            pick = np.where(rng.random((size, width)) < 0.7,
                            rng.choice(recent, size=(size, width)),
                            rng.choice(done, size=(size, width)))
            nbr = np.where(rng.random((size, width)) < 0.8, pick, -1).astype(np.int32)
        w = np.where(nbr >= 0, rng.integers(0, 6, size=nbr.shape), np.inf).astype(np.float32)
        first = np.argsort(nbr < 0, axis=1, kind="stable")  # each row's neighbours first
        levels.append((verts, np.take_along_axis(nbr, first, 1), np.take_along_axis(w, first, 1)))
        done = np.concatenate([done, verts])
    ex_ids = np.full((n + 1, k), -1, np.int32)
    ex_d = np.full((n + 1, k), np.inf, np.float32)
    obj = rng.random(n) < 0.3
    ex_ids[:n, 0] = np.where(obj, np.arange(n), -1)
    ex_d[:n, 0] = np.where(obj, 0.0, np.inf)
    plan = construct.pack_sweep(n, "up", levels, device="cpu")
    assert plan.num_levels == 40 and len(plan.buckets) >= 3
    got = construct.run_sweep(plan, torch.from_numpy(ex_ids), torch.from_numpy(ex_d), k)
    # the reference, one level a step, each level padded to (30, 40): padded
    # rows aim at the dummy row n, padded slots are (-1, +inf)
    step = jax.jit(functools.partial(jops.sweep_merge, k=k, use_pallas=False))
    ids = jnp.full((n + 1, k), -1, jnp.int32)
    d = jnp.full((n + 1, k), jnp.inf, jnp.float32)
    for verts, nbr, w in levels:
        p_verts = np.full(30, n, np.int32)
        p_nbr = np.full((30, 40), -1, np.int32)
        p_w = np.full((30, 40), np.inf, np.float32)
        p_verts[: verts.size] = verts
        p_nbr[: verts.size, : nbr.shape[1]] = nbr
        p_w[: verts.size, : nbr.shape[1]] = w
        ids, d = step(jnp.asarray(p_nbr), jnp.asarray(p_verts), jnp.asarray(p_w),
                      jnp.asarray(ex_ids), jnp.asarray(ex_d), ids, d)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(d))
    assert (got[0].numpy()[:n] >= 0).mean() > 0.3


def test_pack_sweep_refuses_a_neighbour_past_its_rows_width():
    """pack_sweep copies a level's first t_pad columns (its bucket's width,
    from the rows' neighbour counts): a neighbour standing further right
    would be dropped, so it raises; empty slots between neighbours are
    fine."""
    verts = np.array([0, 1], np.int32)
    nbr = np.array([[-1, -1, -1, -1, -1, 2], [3, -1, -1, -1, -1, -1]], np.int32)
    w = np.where(nbr >= 0, 1.0, np.inf).astype(np.float32)
    with pytest.raises(ValueError, match="past column 4"):
        construct.pack_sweep(5, "up", [(verts, nbr, w)], device="cpu")
    holes = np.array([[-1, 2, -1, 4], [3, -1, -1, -1]], np.int32)
    plan = construct.pack_sweep(5, "up", [(verts, holes, np.ones((2, 4), np.float32))],
                                device="cpu")
    assert plan.bucket_signature() == (4,)
    np.testing.assert_array_equal(plan.buckets[0].nbr.numpy(), holes)
    np.testing.assert_array_equal(plan.buckets[0].w.numpy(), np.where(holes >= 0, 1.0, np.inf))


# ---------------------------------------------------------------------------
# the premise of K2's row bound (csrc/sweep_merge.cu: row_bound): every list
# the sweeps read, the extras included, is a row as K2 writes it
# ---------------------------------------------------------------------------


def _rows_as_k2_writes(ids, d, what):
    """Distinct ids, distances ascending, dead entries (-1, +inf) last."""
    ids, d = np.asarray(ids), np.asarray(d)
    live = ids >= 0
    assert (live[:, 1:] <= live[:, :-1]).all(), f"{what}: a live entry after a dead one"
    assert np.isinf(d[~live]).all(), f"{what}: a dead entry not at +inf"
    assert np.isfinite(d[live]).all() and (d[live] >= 0).all(), f"{what}: a live distance"
    both = live[:, 1:]
    assert (d[:, 1:][both] >= d[:, :-1][both]).all(), f"{what}: distances not ascending"
    distinct = np.sort(np.where(live, ids, -1 - np.arange(ids.shape[1])), axis=1)
    assert (np.diff(distinct, axis=1) != 0).all(), f"{what}: an id twice in a row"


@pytest.mark.parametrize("k", [1, 4, 9])
def test_the_sweeps_extras_and_tables_are_rows_as_k2_writes_them(k, monkeypatch):
    bn = port_build_bngraph(port_generators.road_network(12, 12, seed=4))
    objects = port_generators.pick_objects(bn.n, 0.15, seed=2)
    real, sweeps = construct.ops.sweep_merge_levels, []

    def held(buckets, levels, ex_ids, ex_d, vk_ids, vk_d, k, **kwargs):
        _rows_as_k2_writes(ex_ids, ex_d, f"extras of sweep {len(sweeps)}")
        out = real(buckets, levels, ex_ids, ex_d, vk_ids, vk_d, k, **kwargs)
        _rows_as_k2_writes(vk_ids, vk_d, f"tables of sweep {len(sweeps)}")
        sweeps.append(k)
        return out

    monkeypatch.setattr(construct.ops, "sweep_merge_levels", held)
    construct.build_knn_tables(bn, objects, k, device="cpu")
    assert sweeps == [k, k]


def test_the_repair_rounds_hand_k2_rows_as_it_writes_them(monkeypatch):
    from repro_torch import knn
    from repro_torch.core import engine as engine_mod

    bn = port_build_bngraph(port_generators.road_network(10, 10, seed=6))
    k = 4
    objects = port_generators.pick_objects(bn.n, 0.2, seed=1)
    eng = knn.build_engine(bn, objects, k, device="cpu")
    real, rounds = engine_mod.ops.sweep_merge, []

    def held(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k, **kwargs):
        _rows_as_k2_writes(ex_ids, ex_d, f"extras of repair round {len(rounds)}")
        _rows_as_k2_writes(vk_ids, vk_d, f"tables of repair round {len(rounds)}")
        rounds.append(len(verts))
        return real(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k, **kwargs)

    monkeypatch.setattr(engine_mod.ops, "sweep_merge", held)
    rng = np.random.default_rng(3)
    outside = np.setdiff1d(np.arange(bn.n), objects)
    for u in rng.choice(objects, 4, replace=False):
        eng.stage_delete(int(u))
    for u in rng.choice(outside, 4, replace=False):
        eng.stage_insert(int(u))
    eng.stage_move(int(objects[-1]), int(outside[-1]))
    eng.flush_updates()
    assert rounds and sum(rounds) > 0
