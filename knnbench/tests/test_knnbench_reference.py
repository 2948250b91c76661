"""The inputs and the plain reference: the frozen generator gives the port's
network, Dijkstra and the Bellman fixed point give the port's tables, and
the Bellman check fails every table that is not the exact one."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from knnbench import generator
from knnbench.data import road
from knnbench.reference.bellman import Bellman, lowered, round_bits
from knnbench.reference.dijkstra import Dijkstra
from repro_torch.core.construct import build_knn_tables
from repro_torch.core.bngraph import build_bngraph
from repro_torch.graph import csr, generators

CPU = torch.device("cpu")


@pytest.mark.parametrize("nx,ny,seed", [(5, 6, 0), (12, 13, 3), (31, 31, 0), (40, 24, 11)])
def test_frozen_generator_gives_the_ports_network(nx, ny, seed):
    net = road.road_network(nx, ny, seed=seed)
    want = generators.road_network(nx, ny, seed=seed)
    got = csr.from_edges(net.n, net.edges())
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.weights, want.weights)
    assert np.array_equal(generator.object_set(net.n, 0.03, np.random.default_rng(seed)),
                          generators.pick_objects(net.n, 0.03, seed=seed))


def _tables(grid=16, k=6, mu=0.05, seed=4):
    net = road.road_network(grid, grid, seed=seed)
    objects = generator.object_set(net.n, mu, np.random.default_rng(seed + 1))
    bn = build_bngraph(csr.from_edges(net.n, net.edges()))
    ids, d = build_knn_tables(bn, objects, k, device="cpu")
    return net, objects, ids, d


@pytest.fixture(scope="module")
def port():
    return _tables()


def test_dijkstra_gives_the_ports_rows(port):
    net, objects, ids, d = port
    k = ids.shape[1]
    dij = Dijkstra(net.indptr, net.indices, net.weights)
    is_object = np.zeros(net.n, bool)
    is_object[objects] = True
    for u in range(net.n):
        row = dij.knn(is_object, k, u)
        want_ids = [o for o, _ in row] + [-1] * (k - len(row))
        want_d = [x for _, x in row] + [np.inf] * (k - len(row))
        assert ids[u].tolist() == want_ids and d[u].tolist() == want_d, u


def test_bellman_passes_the_ports_tables_and_finds_them_alone(port):
    net, objects, ids, d = port
    bell = Bellman(net.indptr, net.indices, net.weights, CPU, block=100)
    assert not bool(bell.failing_rows(ids, d, objects).any())
    fixed_ids, fixed_d, rounds = bell.fixed_point(objects, ids.shape[1])
    assert torch.equal(fixed_ids, ids) and torch.equal(fixed_d, d) and rounds > 1


def _tie_row(ids, d):
    """A row with two objects at one distance before its last column."""
    for r in range(ids.shape[0] - 1):
        for c in range(ids.shape[1] - 2):
            if d[r, c] == d[r, c + 1] and bool(torch.isfinite(d[r, c])):
                return r, c
    return None


def _fault(name, ids, d, objects, n):
    ids, d = ids.clone(), d.clone()
    if name == "distance_plus_one":
        d[7, 2] += 1
    elif name == "distance_minus_one":
        d[7, 2] -= 1
    elif name == "other_object":
        ids[9, 0] = int(np.setdiff1d(objects, ids[9].numpy())[0])
    elif name == "row_of_a_neighbour":
        ids[5], d[5] = ids[6].clone(), d[6].clone()
    elif name == "last_entry_dropped":
        ids[11, -1], d[11, -1] = -1, float("inf")
    elif name == "padding_row_written":
        ids[n, 0], d[n, 0] = int(objects[0]), 0.0
    elif name == "tie_in_the_larger_id_first":
        r, c = _tie_row(ids, d)
        ids[r, c], ids[r, c + 1] = ids[r, c + 1].clone(), ids[r, c].clone()
    elif name == "duplicate_object":
        ids[3, 1], d[3, 1] = ids[3, 0].clone(), d[3, 0].clone()
    return ids, d


@pytest.mark.parametrize("fault", ["distance_plus_one", "distance_minus_one", "other_object",
                                   "row_of_a_neighbour", "last_entry_dropped",
                                   "padding_row_written", "tie_in_the_larger_id_first",
                                   "duplicate_object"])
def test_bellman_fails_a_planted_fault(port, fault):
    net, objects, ids, d = port
    bell = Bellman(net.indptr, net.indices, net.weights, CPU)
    bad_ids, bad_d = _fault(fault, ids, d, objects, net.n)
    assert int(bell.failing_rows(bad_ids, bad_d, objects).sum()) >= 1


def test_bellman_fails_the_tables_of_another_object_set(port):
    net, objects, ids, d = port
    bell = Bellman(net.indptr, net.indices, net.weights, CPU)
    other = generator.object_set(net.n, 0.05, np.random.default_rng(99))
    # the check is local: at least every vertex that is an object in one set only fails
    changed = np.setxor1d(objects, other)
    bad = bell.failing_rows(ids, d, other)
    assert changed.size and bool(bad[torch.from_numpy(changed.astype(np.int64))].all())


def test_round_bits_and_lowered_tables():
    x = torch.tensor([0.0, 1.0, 17.0, 255.0, 257.0, 300.0, float("inf")])
    assert round_bits(x, 8).tolist() == [0.0, 1.0, 17.0, 255.0, 256.0, 300.0, float("inf")]
    assert round_bits(x, 4).tolist() == [0.0, 1.0, 16.0, 256.0, 256.0, 288.0, float("inf")]
    ids = torch.tensor([[5, 3, -1]], dtype=torch.int32)
    d = torch.tensor([[17.0, 18.0, float("inf")]])
    low_ids, low_d = lowered(ids, d, 4)  # 17 ties and goes to the even 16; 18 stays
    assert low_d.tolist() == [[16.0, 18.0, float("inf")]] and low_ids.tolist() == [[5, 3, -1]]
    low_ids, low_d = lowered(ids, torch.tensor([[17.0, 17.0, float("inf")]]), 4)
    assert low_ids.tolist() == [[3, 5, -1]]  # equal distances: the smaller id first
