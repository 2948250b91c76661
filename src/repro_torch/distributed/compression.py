"""int8 gradient all-reduce with error feedback: the port of
``repro/distributed/compression.py``.

Each replica quantises its (gradient + residual) to int8 with one float32
scale (``max|x| / 127 + 1e-12``, round half to even, clipped to +-127), keeps
the quantisation error as its next residual, and the replicas sum the int8
payloads as int32 and their scales apart; the mean is ``summed * (scale_sum
/ R) / R`` (Karimireddy et al., arXiv:1901.09847).

One process holds the R replicas as a leading dim of ``x`` and of
``residual``; ``psum`` (a sum over that dim) is the seam where R processes
would call ``torch.distributed.all_reduce``. The JAX package maps the same
function over a mesh with ``shard_map``.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale) with x ~ q * scale."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum(x: torch.Tensor) -> torch.Tensor:
    """The all-reduce sum over the replicas (dim 0)."""
    return x.sum(dim=0)


def compressed_psum_mean(x: torch.Tensor, residual: torch.Tensor):
    """Error-feedback int8 all-reduce mean over R replicas: x and residual
    (R, ...), one row a replica. Returns (the mean every replica gets (...),
    the new residuals (R, ...))."""
    corrected = x.to(torch.float32) + residual
    qs, scales = zip(*(quantize_int8(c) for c in corrected))
    q, scale = torch.stack(qs), torch.stack(scales)
    new_residual = corrected - dequantize_int8(q, scale.reshape(-1, *[1] * (q.ndim - 1)))
    summed = psum(q.to(torch.int32))
    scale_sum = psum(scale)
    n = psum(torch.ones((x.shape[0],), dtype=torch.float32, device=x.device))
    return summed.to(torch.float32) * (scale_sum / n) / n, new_residual


def make_compressed_grad_reduce(replicas: int):
    """``reduce(grads, residuals) -> (mean_grads, new_residuals)`` over a tree
    of replicated leaves (every replica holds the same gradient and residual,
    as the JAX package's replicated specs give): each leaf broadcast to
    ``replicas`` rows, reduced, and one replica's residual kept."""
    def reduce_one(g, r):
        rows = lambda t: t.expand(replicas, *t.shape)
        mean, res = compressed_psum_mean(rows(g), rows(r))
        return mean, res[0]

    def reduce(grads, residuals):
        out = [reduce_one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
        means, res = iter([m for m, _ in out]), iter([r for _, r in out])  # leaves order
        return tree_map(lambda _: next(means), grads), tree_map(lambda _: next(res), grads)

    return reduce
