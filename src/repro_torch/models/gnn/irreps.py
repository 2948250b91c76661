"""Real-spherical-harmonic irreps algebra for the E(3)-equivariant GNNs: the
port of ``repro/models/gnn/irreps.py``.

Features carry a dict {l: tensor[..., C, 2l+1]}. The Clebsch-Gordan tables of
the real basis are computed in numpy float64 (the reference's own code: the
complex CG by the Racah formula, taken into the real harmonic basis and
phase-fixed to be real), cached, and cast to a tensor's dtype and device where
they are used. Real l = 1 components are ordered (y, z, x) (e3nn's
convention), so sh_l1(v) = (y, z, x) / |v|; Wigner matrices for l >= 2 follow
the CG recursion D_l = C^T (D_{l-1} x D_1) C, which the equivariance tests use.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

L_MAX = 2


def _su2_cg(j1: float, m1: float, j2: float, m2: float, j3: float, m3: float) -> float:
    """Complex <j1 m1 j2 m2 | j3 m3> via the Racah formula."""
    if m3 != m1 + m2 or not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    f = lambda x: math.factorial(int(round(x)))
    pre = (2 * j3 + 1) * f(j1 + j2 - j3) * f(j1 - j2 + j3) * f(-j1 + j2 + j3) / f(j1 + j2 + j3 + 1)
    pre *= f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1) * f(j2 - m2) * f(j2 + m2)
    s = 0.0
    for k in range(0, int(j1 + j2 + j3) + 2):
        t = [k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k, j3 - j2 + m1 + k, j3 - j1 - m2 + k]
        if any(x < 0 for x in t):
            continue
        s += (-1) ** k / math.prod(f(x) for x in t)
    return math.sqrt(pre) * s


def _real_basis(l: int) -> np.ndarray:
    """U[m_real, m_complex]: complex->real harmonic change of basis."""
    dim = 2 * l + 1
    u = np.zeros((dim, dim), dtype=complex)
    for m in range(-l, l + 1):
        i = m + l
        if m > 0:
            u[i, -m + l] = 1 / math.sqrt(2)
            u[i, m + l] = (-1) ** m / math.sqrt(2)
        elif m == 0:
            u[i, l] = 1.0
        else:
            am = -m
            u[i, -am + l] = 1j / math.sqrt(2)
            u[i, am + l] = -1j * (-1) ** am / math.sqrt(2)
    return u


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C[(2l1+1), (2l2+1), (2l3+1)], orthonormal in c."""
    u1, u2, u3 = _real_basis(l1), _real_basis(l2), _real_basis(l3)
    cg = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=complex)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                cg[m1 + l1, m2 + l2, m3 + l3] = _su2_cg(l1, m1, l2, m2, l3, m3)
    c = np.einsum("au,bv,cw,uvw->abc", np.conj(u1), np.conj(u2), u3, cg)
    # phase-fix: the result is either purely real or purely imaginary
    if np.abs(c.imag).max() > np.abs(c.real).max():
        c = (c * (-1j))
    if np.abs(c.imag).max() >= 1e-10:
        raise ArithmeticError(f"CG {(l1, l2, l3)} is not real: {np.abs(c.imag).max()}")
    return np.ascontiguousarray(c.real)


def cg_paths(l_max: int = L_MAX) -> list[tuple[int, int, int]]:
    """All (l1, l2, l3) with nonzero CG and every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def wigner_d(l: int, r: np.ndarray) -> np.ndarray:
    """Wigner D-matrix for rotation r (3x3) in the real basis, via recursion."""
    q = np.zeros((3, 3))
    q[0, 1], q[1, 2], q[2, 0] = 1, 1, 1  # (x,y,z) -> (y,z,x)
    if l == 0:
        return np.ones((1, 1))
    d1 = q @ r @ q.T
    if l == 1:
        return d1
    d_prev = wigner_d(l - 1, r)
    c = real_cg(l - 1, 1, l).reshape((2 * l - 1) * 3, 2 * l + 1)
    return c.T @ np.kron(d_prev, d1) @ c


def cg_tensor(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    """``real_cg(l1, l2, l3)`` in ``like``'s dtype, on its device."""
    return torch.as_tensor(real_cg(l1, l2, l3), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# tensor-side irreps ops
# ---------------------------------------------------------------------------

def sh(v: torch.Tensor, l_max: int = L_MAX, eps: float = 1e-9) -> dict[int, torch.Tensor]:
    """Real spherical harmonics of directions v (..., 3), unit-normalised.

    Returns {l: (..., 2l+1)}; l=0 constant 1, l=1 = (y,z,x)/|v|, higher l by
    CG recursion (renormalised to unit norm on the sphere)."""
    n = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)
    out = {0: torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)}
    y1 = torch.stack([n[..., 1], n[..., 2], n[..., 0]], dim=-1)
    if l_max >= 1:
        out[1] = y1
    prev = y1
    for l in range(2, l_max + 1):
        yl = torch.einsum("...a,...b,abc->...c", prev, y1, cg_tensor(l - 1, 1, l, v))
        # normalise to unit norm (the norm is direction-independent for exact CG)
        yl = yl / torch.clamp(torch.linalg.vector_norm(yl, dim=-1, keepdim=True), min=eps)
        out[l] = yl
        prev = yl
    return out


def linear_mix(feats: dict[int, torch.Tensor],
               weights: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
    """Per-l channel mixing: weights[l] (C_in, C_out)."""
    return {
        l: torch.einsum("...ci,co->...oi", x, weights[l].to(x.dtype))
        for l, x in feats.items()
        if l in weights
    }


def tensor_product(
    f1: dict[int, torch.Tensor],
    f2: dict[int, torch.Tensor],
    path_w: dict[tuple[int, int, int], torch.Tensor],
    l_max: int = L_MAX,
) -> dict[int, torch.Tensor]:
    """Channel-wise weighted CG tensor product.

    f1[l1]: (..., C, 2l1+1); f2[l2]: (..., 2l2+1) (single-channel filter, e.g.
    spherical harmonics) or (..., C, 2l2+1); path_w[(l1,l2,l3)]: (..., C).
    """
    out: dict[int, torch.Tensor] = {}
    for (l1, l2, l3), w in path_w.items():
        if l1 not in f1 or l2 not in f2:
            continue
        c = cg_tensor(l1, l2, l3, f1[l1])
        x2 = f2[l2]
        if x2.ndim == f1[l1].ndim:  # (..., C, 2l2+1)
            y = torch.einsum("...ka,...kb,abm->...km", f1[l1], x2, c)
        else:
            y = torch.einsum("...ka,...b,abm->...km", f1[l1], x2, c)
        y = y * w[..., None].to(y.dtype)
        out[l3] = out.get(l3, 0) + y
    return out


def gate(feats: dict[int, torch.Tensor], act=F.silu) -> dict[int, torch.Tensor]:
    """Gated nonlinearity: scalars through act; l>0 scaled by act(scalar gate)."""
    out = {0: act(feats[0])}
    if len(feats) > 1:
        g = torch.sigmoid(feats[0].mean(dim=-1, keepdim=True))
        for l, x in feats.items():
            if l > 0:
                out[l] = x * g[..., None] if g.ndim == x.ndim - 1 else x * g
    return out


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with cosine cutoff envelope. r (...,) -> (..., n_rbf)."""
    rc = torch.clamp(r, 1e-6, cutoff)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rc[..., None] / cutoff)
             / rc[..., None])
    env = 0.5 * (torch.cos(math.pi * torch.clamp(r, 0, cutoff) / cutoff) + 1.0)
    return basis * env[..., None]
