"""Plain PyTorch versions of the three kernels (the equality targets).

These run on any device. The CPU tests use them, the wrappers in ``ops.py``
use them for CPU tensors, and the on-card check compares each CUDA kernel
with its function here on the same inputs. Semantics are those of
``kround_merge`` and the ``*_ref`` oracles of the JAX package: exact, no
summation order to differ in (one float32 add, then mins).
"""
from __future__ import annotations

import torch

_INT_MAX = torch.iinfo(torch.int32).max
_INF = float("inf")


def kround_merge(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int):
    """k rounds of dedup min-selection over (B, C) candidates.

    Per row: the k smallest-distance distinct ids, distance ties to the
    smaller id, exhausted slots (-1, +inf). ``cand_d`` must be float32 and
    already +inf wherever ``cand_ids < 0``.
    """
    b, c = cand_ids.shape
    out_ids = torch.full((b, k), -1, dtype=torch.int32, device=cand_ids.device)
    out_d = torch.full((b, k), _INF, dtype=torch.float32, device=cand_ids.device)
    if c == 0 or b == 0:
        return out_ids, out_d
    cd = cand_d
    for i in range(k):
        dmin = cd.min(dim=1).values
        tied = torch.where(cd == dmin[:, None], cand_ids, _INT_MAX)
        idmin = tied.min(dim=1).values
        ok = torch.isfinite(dmin)
        out_ids[:, i] = torch.where(ok, idmin, -1)
        out_d[:, i] = torch.where(ok, dmin, _INF)
        # drop every candidate carrying the selected id: dedup for free
        cd = torch.where(cand_ids == idmin[:, None], _INF, cd)
    return out_ids, out_d


def topk_merge_ref(cand_ids: torch.Tensor, cand_d: torch.Tensor, k: int):
    """k smallest-distance distinct ids per row; ties broken by smaller id.

    ``cand_ids`` (B, C) int32 with -1 = invalid, ``cand_d`` (B, C) float32 or
    float16 (math in float32, output in the input type). ``C < k`` works: the
    missing slots come out as (-1, +inf).
    """
    d = torch.where(cand_ids < 0, _INF, cand_d.to(torch.float32))
    out_ids, out_d = kround_merge(cand_ids, d, k)
    return out_ids, out_d.to(cand_d.dtype)


def sweep_candidates(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d):
    """The explicit (S, T*k+E) candidate tensors of one sweep step."""
    s, t = nbr.shape
    k = vk_ids.shape[1]
    n1 = vk_ids.shape[0]
    valid = nbr >= 0
    nbr_c = torch.where(valid, nbr, n1 - 1).long()
    g_ids = torch.where(valid[..., None], vk_ids[nbr_c], -1)
    g_d = w[..., None] + vk_d[nbr_c]
    rows = verts.long()
    cand_ids = torch.cat([g_ids.reshape(s, t * k), ex_ids[rows]], dim=1)
    cand_d = torch.cat([g_d.reshape(s, t * k), ex_d[rows]], dim=1).to(torch.float32)
    return cand_ids, torch.where(cand_ids < 0, _INF, cand_d)


def sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k: int):
    """Merged (S, k) rows of one sweep step, as an explicit candidate tensor.

    gather neighbour k-lists -> shift by edge weight -> append extras -> dedup
    top-k. Row i is the new content of table row ``verts[i]``; the tables are
    not written (see ``ops.sweep_merge`` for the scatter).

    nbr (S, T) int32 with -1 pads, verts (S,) int32 with n = dummy row,
    w (S, T) float32, ex_* (n+1, E), vk_* (n+1, k).
    """
    cand_ids, cand_d = sweep_candidates(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d)
    return kround_merge(cand_ids, cand_d, k)


def frontier_relax_ref(nbr, rows, w, dist, kth, src):
    """New (R, B) receiver rows of one pruned-relaxation (checkIns) round.

    For receiver row v = rows[i] and source column c:
        new[i, c] = min(dist[v, c], min over u in nbr[i], gate(u, c) of
                                        w[i, j] + dist[u, c])
        gate(u, c) = dist[u, c] < kth[u]  or  u == src[c]
    Pure Jacobi: ``dist`` is only read. One neighbour column at a time, so
    only (R, B) intermediates exist.

    nbr (R, T) int32 with -1 pads, rows (R,) int32 with n = dummy row,
    w (R, T) float32, dist (n+1, B) float32, kth (n+1,) float32,
    src (B,) int32 with -1 pads.
    """
    n1 = dist.shape[0]
    acc = dist[rows.long()]
    for j in range(nbr.shape[1]):
        nv = nbr[:, j]
        valid = nv >= 0
        nc = torch.where(valid, nv, n1 - 1)
        ncl = nc.long()
        nd = dist[ncl]
        gate = (nd < kth[ncl][:, None]) | (nc[:, None] == src[None, :])
        cand = w[:, j, None] + nd
        acc = torch.minimum(acc, torch.where(valid[:, None] & gate, cand, _INF))
    return acc
