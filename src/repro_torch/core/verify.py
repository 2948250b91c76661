"""BN-Graph certificates (tropical-algebra checks), on the device.

Definition 5.3(2) says every G' edge weight equals the true shortest
distance. A cheap necessary-and-locally-sufficient certificate is
*relaxation stability*: the weighted adjacency A (with 0 diagonal, +inf
non-edges) must satisfy  min(A, A (min,+) A) == A on the edge support,
i.e. one tropical square cannot improve any edge. Algorithm 1's edge
deletion is exactly the per-vertex form of this relaxation, so the check is
the batched form of the paper's Step 2 invariant, evaluated with the
``minplus_matmul`` kernel (``kernels/csrc/minplus.cu``).

Used by tests and by ``launch/knn_build.py --verify`` at verification scale
(a dense (n, n) tropical square: n = 19,881 is 1.58 GB of float32 per
matrix). The dense adjacency and the rank-direction check are host Python,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bngraph import BNGraph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def bngraph_dense_adjacency(bn: BNGraph) -> np.ndarray:
    a = np.full((bn.n, bn.n), np.inf, dtype=np.float32)
    np.fill_diagonal(a, 0.0)
    for v in range(bn.n):
        for u, w in bn.bns(v):
            a[v, u] = min(a[v, u], w)
    return a


def relaxation_stable(
    bn: BNGraph, *, device="cuda", use_kernel: bool = True, atol: float = 1e-5
) -> bool:
    """True iff one (min,+) square cannot improve any existing G' edge."""
    dev = resolve_device(device)
    a = torch.from_numpy(bngraph_dense_adjacency(bn)).to(dev)
    sq = ops.minplus_matmul(a, a, use_kernel=use_kernel)
    edges = torch.isfinite(a)
    edges.fill_diagonal_(False)
    return bool(torch.all(sq[edges] >= a[edges] - atol))


def rank_consistent(bn: BNGraph) -> bool:
    """Every BNS^< neighbour ranks below its vertex, every BNS^> one above."""
    ok = True
    for v in range(bn.n):
        for u, _ in bn.bns_lower(v):
            ok &= bn.rank[u] < bn.rank[v]
        for u, _ in bn.bns_higher(v):
            ok &= bn.rank[u] > bn.rank[v]
    return bool(ok)


def certificate(bn: BNGraph, *, device="cuda", use_kernel: bool = True) -> dict:
    """Full certificate: relaxation stability + rank-direction consistency."""
    ok_relax = relaxation_stable(bn, device=device, use_kernel=use_kernel)
    ok_levels = rank_consistent(bn)
    return {"relaxation_stable": ok_relax, "rank_consistent": ok_levels,
            "ok": ok_relax and ok_levels}
