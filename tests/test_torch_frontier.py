"""The update frontiers of the port against a brute-force multi-source
Dijkstra oracle, with the JAX package beside it as the reference: the three
properties of ``tests/core/test_frontier_property.py``, run on the CPU
through the port's ``core/updates.py`` and the plain versions of
``ops.frontier_relax`` and ``ops.rows_containing``.

Road networks with continuous edge weights (ties have probability zero, so
every set is exact):

* insert u: the checkIns frontier == {w : dist(w, u) < kth(w)} | {u}, with
  exact distances, covering every row the brute-force index changes, and
  equal (sets and distances) to the JAX package's ``insert_affected_set``;
* ``frontier_relax`` rounds for a batch of inserted objects reach a fixpoint
  whose per-column sets are the per-source checkIns sets (float32 distances
  within rtol 2e-6 of the oracle's float64 sums, the JAX test's tolerance),
  and whose (n+1, B) matrix equals the JAX package's fixpoint bit for bit
  (the same float32 additions and minima);
* delete u: the checkDel frontier == the rows naming u == the rows the
  brute-force index changes == ``rows_containing``, each equal to the JAX
  package's.
"""
import dataclasses
import heapq

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import bngraph as jbngraph
from repro.core import updates as jupdates
from repro.core.index import index_from_lists as jindex_from_lists
from repro.graph import generators as jgen
from repro.kernels import ops as jops
from repro_torch.core.bngraph import build_bngraph
from repro_torch.core.index import PAD_ID, KNNIndex, index_from_lists
from repro_torch.core.updates import _affected_set, insert_affected_set
from repro_torch.graph.csr import Graph
from repro_torch.graph.generators import pick_objects, road_network
from repro_torch.kernels import ops


def _sssp(g: Graph, src: int) -> np.ndarray:
    """Plain single-source Dijkstra over the road network; (n,) distances."""
    dist = np.full(g.n, np.inf)
    dist[src] = 0.0
    heap = [(0.0, src)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        nbrs, ws = g.neighbors(v)
        for nb, w in zip(nbrs.tolist(), ws.tolist()):
            nd = d + w
            if nd < dist[nb]:
                dist[nb] = nd
                heapq.heappush(heap, (nd, nb))
    return dist


def _brute_rows(g: Graph, objects: np.ndarray, k: int) -> list:
    """Ground truth: one Dijkstra per object, top-k per vertex."""
    dmat = np.stack([_sssp(g, int(o)) for o in objects], axis=1)  # (n, |M|)
    rows = []
    for v in range(g.n):
        order = np.lexsort((objects, dmat[v]))[:k]
        rows.append([(int(objects[j]), float(dmat[v, j])) for j in order
                     if np.isfinite(dmat[v, j])])
    return rows


def _brute_knn(g: Graph, objects: np.ndarray, k: int) -> KNNIndex:
    return index_from_lists(g.n, k, _brute_rows(g, objects, k))


def _kth(index: KNNIndex, v: int) -> float:
    return np.inf if index.ids[v, -1] == PAD_ID else float(index.dists[v, -1])


def _changed_rows(a: KNNIndex, b: KNNIndex) -> set:
    return {
        v
        for v in range(a.n)
        if not (
            np.array_equal(a.ids[v], b.ids[v])
            and np.allclose(
                np.where(np.isinf(a.dists[v]), -1, a.dists[v]),
                np.where(np.isinf(b.dists[v]), -1, b.dists[v]),
            )
        )
    }


params = st.tuples(
    st.integers(min_value=3, max_value=6),   # grid nx
    st.integers(min_value=3, max_value=6),   # grid ny
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=1, max_value=4),   # k
)


@dataclasses.dataclass
class Case:
    g: Graph
    objects: np.ndarray
    bn: object       # the port's BN-Graph
    jbn: object      # the JAX package's, from its own copy of the network
    idx: KNNIndex    # the port's brute-force index
    jidx: object     # the same rows as the JAX package's KNNIndex
    k: int


def _setup(nx, ny, seed, k) -> Case:
    g = road_network(nx, ny, seed=seed, integer_weights=False)
    jg = jgen.road_network(nx, ny, seed=seed, integer_weights=False)
    objects = pick_objects(g.n, 0.35, seed=seed)
    rows = _brute_rows(g, objects, k)
    return Case(g, objects, build_bngraph(g), jbngraph.build_bngraph(jg),
                index_from_lists(g.n, k, rows), jindex_from_lists(g.n, k, rows), k)


@settings(max_examples=12, deadline=None)
@given(params)
def test_insert_frontier_matches_brute_force(p):
    nx, ny, seed, k = p
    c = _setup(nx, ny, seed, k)
    g, idx = c.g, c.idx
    outside = np.setdiff1d(np.arange(g.n), c.objects)
    if outside.size == 0:
        return
    u = int(outside[np.random.default_rng(seed).integers(0, outside.size)])

    dist_u = _sssp(g, u)
    affected = insert_affected_set(c.bn, lambda v: _kth(idx, v), u)

    expected = {w for w in range(g.n) if dist_u[w] < _kth(idx, w)} | {u}
    assert set(affected) == expected
    for w, d in affected.items():  # BN-Graph preserves exact distances
        assert np.isclose(d, dist_u[w])
    assert affected == jupdates.insert_affected_set(c.jbn, lambda v: _kth(idx, v), u)

    # every row the ground-truth index changes is in the frontier
    after = _brute_knn(g, np.sort(np.append(c.objects, u)), k)
    assert _changed_rows(idx, after) <= set(affected)


def _relax_to_fixpoint(bn, kth: np.ndarray, srcs: np.ndarray, relax):
    """Drive ``relax`` (the port's ``ops.frontier_relax`` on CPU tensors, or
    the JAX package's plain one) to its fixpoint in float32, the engine's
    dtype; returns the converged (n+1, B) matrix."""
    packed = bn.bns_packed()
    n, b = bn.n, len(srcs)
    kth32 = np.append(kth, np.inf).astype(np.float32)
    dist = np.full((n + 1, b), np.inf, np.float32)
    dist[srcs, np.arange(b)] = 0.0
    active = np.unique(srcs)
    for _ in range(300):
        recv = np.unique(packed.ids[active])
        recv = recv[recv >= 0].astype(np.int32)
        new = relax(packed.ids[recv].astype(np.int32), recv,
                    packed.w[recv].astype(np.float32), dist, kth32, srcs.astype(np.int32))
        changed = (new[recv] < dist[recv]).any(axis=1)
        dist = new
        active = recv[changed]
        if not active.size:
            return dist
    raise AssertionError("frontier relaxation did not converge")


def _port_relax(nbr, rows, w, dist, kth, src):
    """The port's round: a fresh (R, B) tile, scattered into a copy of dist."""
    t = torch.from_numpy
    tile = ops.frontier_relax(t(nbr), t(rows), t(w), t(dist), t(kth), t(src))
    out = dist.copy()
    out[rows] = tile.numpy()
    return out


def _jax_relax(nbr, rows, w, dist, kth, src):
    j = jnp.asarray
    return np.asarray(jops.frontier_relax(j(nbr), j(rows), j(w), j(dist), j(kth), j(src),
                                          use_pallas=False))


@settings(max_examples=12, deadline=None)
@given(params)
def test_frontier_relax_fixpoint_matches_insert_affected_set(p):
    """Rounds for a batch of inserted objects land on the per-source checkIns
    sets of the host oracle, and on the JAX package's fixpoint exactly."""
    nx, ny, seed, k = p
    c = _setup(nx, ny, seed, k)
    outside = np.setdiff1d(np.arange(c.g.n), c.objects)
    if outside.size < 2:
        return
    rng = np.random.default_rng(seed)
    b = min(4, outside.size)
    srcs = np.sort(rng.choice(outside, size=b, replace=False))

    # BNS weights and the pruning column pre-rounded to float32, so the
    # oracle's host sums and the relaxation see the same inputs
    bn = dataclasses.replace(
        c.bn,
        lo_w=c.bn.lo_w.astype(np.float32).astype(np.float64),
        hi_w=c.bn.hi_w.astype(np.float32).astype(np.float64),
    )
    kth = np.array([_kth(c.idx, v) for v in range(c.g.n)])
    kth = kth.astype(np.float32).astype(np.float64)

    dist = _relax_to_fixpoint(bn, kth, srcs, _port_relax)
    np.testing.assert_array_equal(dist, _relax_to_fixpoint(bn, kth, srcs, _jax_relax))
    for i, u in enumerate(srcs.tolist()):
        want = insert_affected_set(bn, lambda v: float(kth[v]), u)
        got = {v for v in range(c.g.n) if dist[v, i] < kth[v] or v == u}
        assert got == set(want)
        for v, d in want.items():
            assert np.isclose(float(dist[v, i]), d, rtol=2e-6, atol=0)


@settings(max_examples=12, deadline=None)
@given(params)
def test_delete_frontier_matches_brute_force(p):
    nx, ny, seed, k = p
    c = _setup(nx, ny, seed, k)
    g, idx = c.g, c.idx
    u = int(c.objects[np.random.default_rng(seed).integers(0, len(c.objects))])

    naming_u = {w for w in range(g.n) if u in idx.ids[w]}

    # the oracle's checkDel frontier explores exactly the rows naming u
    affected = _affected_set(c.bn, idx, u, for_delete=True)
    assert set(affected) == naming_u
    dist_u = _sssp(g, u)
    for w, d in affected.items():
        assert np.isclose(d, dist_u[w])
    assert affected == jupdates._affected_set(c.jbn, c.jidx, u, for_delete=True)

    # the engine's scan finds the same delete frontier
    tables = np.concatenate([idx.ids, np.full((1, k), PAD_ID, np.int32)])
    hit = ops.rows_containing(torch.from_numpy(tables), torch.tensor([u], dtype=torch.int32))
    assert set(np.flatnonzero(hit.numpy()).tolist()) == naming_u
    jhit = np.asarray(jops.rows_containing(jnp.asarray(tables), jnp.asarray([u], jnp.int32)))
    np.testing.assert_array_equal(hit.numpy(), jhit)

    # and the ground-truth index changes exactly on those rows
    after = _brute_knn(g, c.objects[c.objects != u], k)
    assert _changed_rows(idx, after) == naming_u
