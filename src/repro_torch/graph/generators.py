"""Synthetic road-network generators.

The container is offline, so the DIMACS road networks from the paper are not
available. Road networks are near-planar, low-degree (avg deg ~2.5-3.5),
locally meshy graphs; we generate grid-based networks with random edge
deletions, diagonal shortcuts and distance-like weights, which match the
structural statistics (small eta/tau/rho, Table 2) that the paper's algorithms
exploit.
"""
from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges, is_connected


def road_network(
    nx: int,
    ny: int,
    *,
    seed: int = 0,
    delete_frac: float = 0.18,
    diag_frac: float = 0.08,
    weight_low: float = 1.0,
    weight_high: float = 10.0,
    integer_weights: bool = True,
) -> Graph:
    """Grid-city road network: nx*ny intersections, Manhattan-ish streets.

    Edges get physical-distance-like weights; a fraction of streets is removed
    (keeping the network connected) and a few diagonal connectors added, which
    reproduces the low-treewidth, small-separator structure of real road nets.
    """
    rng = np.random.default_rng(seed)
    n = nx * ny
    vid = lambda x, y: x * ny + y

    edges: list[tuple[int, int, float]] = []
    for x in range(nx):
        for y in range(ny):
            if x + 1 < nx:
                edges.append((vid(x, y), vid(x + 1, y), 0.0))
            if y + 1 < ny:
                edges.append((vid(x, y), vid(x, y + 1), 0.0))

    # Random deletions, preserving connectivity via a kept spanning tree.
    edges_arr = np.array([(u, v) for u, v, _ in edges], dtype=np.int64)
    perm = rng.permutation(len(edges_arr))
    parent = np.arange(n)

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    in_tree = np.zeros(len(edges_arr), dtype=bool)
    for idx in perm:
        u, v = edges_arr[idx]
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[ru] = rv
            in_tree[idx] = True

    deletable = np.flatnonzero(~in_tree)
    n_del = int(delete_frac * len(edges_arr))
    to_del = set(rng.choice(deletable, size=min(n_del, len(deletable)), replace=False).tolist())
    kept = [(int(edges_arr[i, 0]), int(edges_arr[i, 1])) for i in range(len(edges_arr)) if i not in to_del]

    # Diagonal connectors.
    n_diag = int(diag_frac * n)
    for _ in range(n_diag):
        x = int(rng.integers(0, nx - 1))
        y = int(rng.integers(0, ny - 1))
        if rng.random() < 0.5:
            kept.append((vid(x, y), vid(x + 1, y + 1)))
        else:
            kept.append((vid(x + 1, y), vid(x, y + 1)))

    ws = rng.uniform(weight_low, weight_high, size=len(kept))
    if integer_weights:
        ws = np.maximum(1.0, np.round(ws))
    g = from_edges(n, [(u, v, float(w)) for (u, v), w in zip(kept, ws)])
    assert is_connected(g), "generator must produce a connected network"
    return g


def random_connected_graph(
    n: int, extra_edges: int, *, seed: int = 0, weight_low: float = 1.0, weight_high: float = 20.0
) -> Graph:
    """Random connected graph: random spanning tree + extra random edges.

    Used by property-based tests (small n, arbitrary topology).
    """
    rng = np.random.default_rng(seed)
    edges: list[tuple[int, int, float]] = []
    order = rng.permutation(n)
    for i in range(1, n):
        j = int(rng.integers(0, i))
        edges.append((int(order[i]), int(order[j]), 0.0))
    for _ in range(extra_edges):
        u = int(rng.integers(0, n))
        v = int(rng.integers(0, n))
        if u != v:
            edges.append((u, v, 0.0))
    ws = np.maximum(1.0, np.round(rng.uniform(weight_low, weight_high, size=len(edges))))
    return from_edges(n, [(u, v, float(w)) for (u, v, _), w in zip(edges, ws)])


def pick_objects(n: int, mu: float, *, seed: int = 0) -> np.ndarray:
    """Candidate object set M: random vertices at density mu=|M|/|V| (paper §7)."""
    rng = np.random.default_rng(seed)
    size = max(1, int(round(mu * n)))
    return np.sort(rng.choice(n, size=size, replace=False)).astype(np.int32)
