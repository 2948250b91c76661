"""The port's TEN-Index-lite (``repro_torch/core/baselines.py``, numpy only)
held against the Dijkstra oracle, as ``tests/core/test_baselines.py`` holds
the JAX package's, and against the JAX package's own ``TENIndexLite``: the
same kNN answers (ids and distances exactly: the same Python float sums in
the same order) and the same label, kTNN and bag sizes."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import baselines as jbaselines
from repro.graph import generators as jgen
from repro_torch.core.baselines import TENIndexLite
from repro_torch.core.index import indices_equivalent
from repro_torch.core.reference import dijkstra_cons
from repro_torch.graph.generators import pick_objects, random_connected_graph, road_network


@settings(max_examples=12, deadline=None)
@given(
    st.tuples(
        st.integers(min_value=6, max_value=40),
        st.integers(min_value=0, max_value=40),
        st.integers(min_value=0, max_value=10_000),
        st.integers(min_value=1, max_value=5),
    )
)
def test_ten_lite_matches_oracle(p):
    n, extra, seed, k = p
    g = random_connected_graph(n, extra_edges=extra, seed=seed)
    objects = pick_objects(n, 0.6, seed=seed)
    ten = TENIndexLite(g, objects, k)
    oracle = dijkstra_cons(g, objects, k)
    assert indices_equivalent(oracle, ten.build_knn_index())


def test_h2h_dominates_size():
    """The paper's motivation: H2H labels dwarf the kNN part of TEN-Index."""
    g = road_network(16, 16, seed=1)
    objects = pick_objects(g.n, 0.1, seed=1)
    ten = TENIndexLite(g, objects, 10)
    s = ten.size_entries()
    assert s["h2h_entries"] > 3 * s["ktnn_entries"]


@pytest.mark.parametrize("side,mu,k,seed", [(12, 0.1, 5, 0), (16, 0.05, 10, 1), (9, 0.5, 3, 7)])
def test_ten_lite_equals_the_jax_package(side, mu, k, seed):
    """Same road network, same objects: every vertex's kNN answer, every
    point-to-point distance sampled, and every size equal to the JAX one's."""
    g = road_network(side, side, seed=seed)
    jg = jgen.road_network(side, side, seed=seed)
    objects = pick_objects(g.n, mu, seed=seed)
    ours = TENIndexLite(g, objects, k)
    theirs = jbaselines.TENIndexLite(jg, objects, k)
    assert ours.size_entries() == theirs.size_entries()
    assert ours.size_bytes() == theirs.size_bytes()
    np.testing.assert_array_equal(ours.order, theirs.order)
    np.testing.assert_array_equal(ours.parent, theirs.parent)
    for u in range(g.n):
        assert ours.knn(u) == theirs.knn(u)
        assert ours.knn(u, 2) == theirs.knn(u, 2)
    rng = np.random.default_rng(seed)
    for u, v in rng.integers(0, g.n, size=(50, 2)).tolist():
        assert ours.dist(u, v) == theirs.dist(u, v)
    a, b = ours.build_knn_index(), theirs.build_knn_index()
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
