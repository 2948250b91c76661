"""The layers of the dense decoder, as plain torch functions over dicts of
tensors: the port of ``repro/models/nn.py`` (dense, RMSNorm, RoPE) and, for
its ``chunked_attention``, ``attention``, which runs the K6 kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              use_kernel: bool = True) -> torch.Tensor:
    """Softmax attention, q (B, S, H, D), k and v (B, T, Hkv, D) -> (B, S, H, D):
    the function the JAX package computes with ``chunked_attention``
    (grouped-query heads without repeating K and V, causal on absolute
    positions, float32 statistics), here by the K6 kernel on the card."""
    return ops.flash_attention(q, k, v, causal=causal, use_kernel=use_kernel)
