"""The layers of the dense decoder, as plain torch functions over dicts of
tensors: the port of ``repro/models/nn.py`` (dense, RMSNorm, RoPE,
``cross_entropy``) and, for its ``chunked_attention``, ``attention``, which
runs the K6 kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.common import normal


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32) -> dict:
    p = {"w": normal(gen, (d_in, d_out), d_in**-0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, *, device) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics, output in x's type."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"].to(torch.float32)).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, split-half form, float32 angles. x (..., S, H, D);
    pos (S,) integer positions."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos.to(torch.float32)[..., None] * inv  # (S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class _KernelAttention(torch.autograd.Function):
    """K6 forward; the backward differentiates the plain attention.

    The JAX package has no backward kernel: it differentiates the plain
    ``chunked_attention`` (blocks with an online softmax) under ``jax.grad``.
    So does this backward: it recomputes ``ref.flash_attention_ref`` (the
    same blocked online softmax) from the saved q, k and v under autograd
    and returns its vector-Jacobian product. Only the forward runs K6.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = ref.flash_attention_ref(*inputs, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              use_kernel: bool = True) -> torch.Tensor:
    """Softmax attention, q (B, S, H, D), k and v (B, T, Hkv, D) -> (B, S, H, D):
    the function the JAX package computes with ``chunked_attention``
    (grouped-query heads without repeating K and V, causal on absolute
    positions, float32 statistics), here by the K6 kernel on the card.

    Differentiable: on the card the forward is K6 and the backward
    differentiates the plain attention (``_KernelAttention``); on the CPU, or
    with ``use_kernel=False``, the whole of it is the plain attention under
    autograd. On ``meta`` (the dry run's count) it takes the card's form, so
    a step counts the card's work there."""
    if (q.is_cuda or q.is_meta) and use_kernel:
        return _KernelAttention.apply(q, k, v, causal)
    return ops.flash_attention(q, k, v, causal=causal, use_kernel=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, stable in float32. logits (..., V), labels
    (...) integer."""
    lg = logits.to(torch.float32)
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
