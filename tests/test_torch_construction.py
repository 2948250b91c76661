"""The port's construction (``repro_torch.core.construct``, on the CPU) held
against the JAX package's ``build_knn_tables_jax(use_pallas=False)``:
``array_equal`` on both (n+1, k) tables, int32 ids and float32 distances
(tolerance exact: one float32 add and mins, no summation order), and against
the float64 host oracle ``knn_index_cons_plus`` via ``indices_equivalent``
(atol 1e-9, integer edge weights). The BN-Graph is built once by the JAX
package and carried across with ``bngraph_from_arrays``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.bngraph import build_bngraph
from repro.core.construct_jax import build_knn_tables_jax
from repro.core.construct_jax import prepare_sweep as jax_prepare_sweep
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
    cells = sum(size * plan.buckets[bid].t_pad
                for bid, size in zip(plan.level_bucket, plan.level_sizes))
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
    for bid, off, size in zip(plan.level_bucket, plan.level_off, plan.level_sizes):
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
