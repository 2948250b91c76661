"""The benchmark's own road network.

A frozen copy of ``repro_torch.graph.generators.road_network`` (object sets
are ``generator.object_set``): the same random stream gives the same edge
list, so the port is handed exactly the network its own generator would
make, while the benchmark's inputs stay fixed when the program's changes. The
spanning tree that keeps the network connected is Kruskal's over the
shuffled edge order; with distinct keys that tree is unique, so scipy's
minimum spanning tree over the keys gives the same tree as the original's
union-find loop, in a fraction of the time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import minimum_spanning_tree


@dataclasses.dataclass(frozen=True)
class Network:
    """An undirected road network: edge list and both-direction CSR."""

    n: int
    src: np.ndarray      # (m,) int64, one entry an edge, as generated
    dst: np.ndarray      # (m,) int64
    w: np.ndarray        # (m,) float64
    indptr: np.ndarray   # (n+1,) int64 over both directions
    indices: np.ndarray  # (2m,) int64
    weights: np.ndarray  # (2m,) float64

    def edges(self) -> list[tuple[int, int, float]]:
        """The edge list as ``graph.csr.from_edges`` takes it."""
        return list(zip(self.src.tolist(), self.dst.tolist(), self.w.tolist()))


def road_network(nx: int, ny: int, *, seed: int = 0, delete_frac: float = 0.18,
                 diag_frac: float = 0.08, weight_low: float = 1.0, weight_high: float = 10.0,
                 integer_weights: bool = True) -> Network:
    """Grid city of nx*ny intersections with random street deletions (kept
    connected) and diagonal connectors; the original's draws, in its order."""
    rng = np.random.default_rng(seed)
    n = nx * ny
    # the original appends, for x then y, the edge to (x+1, y) and then to (x, y+1)
    x, y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v = (x * ny + y).ravel()
    right = (x + 1 < nx).ravel()
    up = (y + 1 < ny).ravel()
    pairs = np.full((n, 2, 2), -1, np.int64)
    pairs[:, 0, 0] = v
    pairs[:, 0, 1] = v + ny
    pairs[:, 1, 0] = v
    pairs[:, 1, 1] = v + 1
    keep = np.stack([right, up], axis=1).ravel()
    edges = pairs.reshape(-1, 2)[keep]
    m = len(edges)

    perm = rng.permutation(m)
    key = np.empty(m, np.float64)
    key[perm] = np.arange(1, m + 1)
    tree = minimum_spanning_tree(coo_matrix((key, (edges[:, 0], edges[:, 1])), shape=(n, n)))
    # a tree edge's key - 1 is its position in perm
    in_tree = np.zeros(m, bool)
    in_tree[perm[np.rint(tree.tocoo().data).astype(np.int64) - 1]] = True

    deletable = np.flatnonzero(~in_tree)
    n_del = int(delete_frac * m)
    to_del = rng.choice(deletable, size=min(n_del, len(deletable)), replace=False)
    kept_mask = np.ones(m, bool)
    kept_mask[to_del] = False

    n_diag = int(diag_frac * n)
    diag = np.empty((n_diag, 2), np.int64)
    for i in range(n_diag):
        dx = int(rng.integers(0, nx - 1))
        dy = int(rng.integers(0, ny - 1))
        if rng.random() < 0.5:
            diag[i] = (dx * ny + dy, (dx + 1) * ny + dy + 1)
        else:
            diag[i] = ((dx + 1) * ny + dy, dx * ny + dy + 1)
    kept = np.concatenate([edges[kept_mask], diag])

    ws = rng.uniform(weight_low, weight_high, size=len(kept))
    if integer_weights:
        ws = np.maximum(1.0, np.round(ws))
    return _network(n, kept[:, 0], kept[:, 1], ws)


def _network(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> Network:
    both_src = np.concatenate([src, dst])
    both_dst = np.concatenate([dst, src])
    both_w = np.concatenate([w, w])
    order = np.lexsort((both_dst, both_src))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(both_src, minlength=n), out=indptr[1:])
    return Network(n=n, src=src.astype(np.int64), dst=dst.astype(np.int64), w=w.astype(np.float64),
                   indptr=indptr, indices=both_dst[order].astype(np.int64),
                   weights=both_w[order].astype(np.float64))

