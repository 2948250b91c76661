"""MACE (Batatia et al., arXiv:2206.07697): higher-order equivariant message
passing through the Atomic Cluster Expansion, the port of
``repro/models/gnn/mace.py`` (assigned config: 2 layers, 128 channels,
l_max = 2, correlation order 3, 8 Bessel RBFs).

Each layer builds the A-basis (one tensor-product interaction summed over
edges), then the B-basis by channel-wise symmetric CG powers of A up to order
3 with per-(path, channel) weights ``w2`` / ``w3`` keyed "l1_l2_l3". The
B-basis cubes unnormalised edge sums, so at the full config losses reach
~1e13: compare mace by each value's largest magnitude, not absolutely.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import generator, resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, normal
from repro_torch.models.gnn import common, irreps


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    d_feat: int = 0
    n_out: int = 1
    task: str = "energy"
    param_dtype: torch.dtype = torch.float32


def _paths(cfg):
    return irreps.cg_paths(cfg.l_max)


def init_params(cfg: MACEConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = generator(resolve_device(device), seed)
    c, dt = cfg.d_hidden, cfg.param_dtype
    paths = _paths(cfg)
    ls = range(cfg.l_max + 1)
    lin = lambda: {str(l): normal(gen, (c, c), c**-0.5, dt) for l in ls}
    # per-path per-channel weights for the order-2 / order-3 products
    per_path = lambda: {f"{a}_{b}_{o}": normal(gen, (c,), 0.3, dt) for (a, b, o) in paths}
    layers = [{"radial": mlp_init(gen, [cfg.n_rbf, 64, len(paths) * c], dt),
               "lin_pre": lin(), "w2": per_path(), "w3": per_path(),
               "lin_msg": lin(), "lin_res": lin()}
              for _ in range(cfg.n_layers)]
    if cfg.d_feat > 0:
        enc = mlp_init(gen, [cfg.d_feat, c], dt)
    else:
        enc = normal(gen, (cfg.n_species, c), 0.5, dt)
    return {"encoder": enc, "layers": layers, "readout": mlp_init(gen, [c, c, cfg.n_out], dt)}


def _sym_power(a: dict, w_tab: dict, cfg, base: dict) -> dict:
    """One channel-wise CG power step: out[l3] = sum_paths w * CG(a[l1] x base[l2])."""
    out: dict[int, torch.Tensor] = {}
    for (l1, l2, l3) in _paths(cfg):
        if l1 not in a or l2 not in base:
            continue
        w = w_tab[f"{l1}_{l2}_{l3}"]
        c = irreps.cg_tensor(l1, l2, l3, a[l1])
        y = (torch.einsum("nka,nkb,abm->nkm", a[l1], base[l2], c)
             * w[None, :, None].to(a[l1].dtype))
        out[l3] = out.get(l3, 0) + y
    return out


def forward(params, batch, cfg: MACEConfig) -> torch.Tensor:
    src, dst = batch["edge_index"]
    pos = batch["pos"]
    n = pos.shape[0]
    c = cfg.d_hidden
    rel = pos[dst] - pos[src]
    r = torch.linalg.vector_norm(rel, dim=-1)
    rbf = irreps.bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    ylm = irreps.sh(rel, cfg.l_max)
    paths = _paths(cfg)

    if cfg.d_feat > 0:
        s = mlp_apply(params["encoder"], batch["node_feat"].to(cfg.param_dtype), final_act=True)
    else:
        s = common.take_rows(params["encoder"], batch["species"])
    s = s.to(cfg.param_dtype)
    rbf = rbf.to(cfg.param_dtype)
    ylm = {l: y.to(cfg.param_dtype) for l, y in ylm.items()}
    feats = {0: s[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n, c, 2 * l + 1), dtype=s.dtype, device=s.device)

    site_energies = 0.0
    for lp in params["layers"]:
        h = irreps.linear_mix(feats, {int(l): w for l, w in lp["lin_pre"].items()})
        radial = mlp_apply(lp["radial"], rbf).reshape(-1, len(paths), c)
        src_feats = {l: x[src] for l, x in h.items()}
        path_w = {p: radial[:, i, :] for i, p in enumerate(paths)}
        msgs = irreps.tensor_product(src_feats, ylm, path_w, cfg.l_max)
        # A-basis: aggregated one-particle basis
        a_basis = {
            l: common.scatter_sum(m.reshape(m.shape[0], -1), dst, n).reshape(n, c, 2 * l + 1)
            for l, m in msgs.items()
        }
        # B-basis: symmetric channel-wise powers (correlation order 3)
        b = dict(a_basis)
        prod = a_basis
        if cfg.correlation_order >= 2:
            prod = _sym_power(prod, lp["w2"], cfg, a_basis)
            for l, x in prod.items():
                b[l] = b.get(l, 0) + x
        if cfg.correlation_order >= 3:
            prod = _sym_power(prod, lp["w3"], cfg, a_basis)
            for l, x in prod.items():
                b[l] = b.get(l, 0) + x
        m = irreps.linear_mix(b, {int(l): w for l, w in lp["lin_msg"].items()})
        res = irreps.linear_mix(feats, {int(l): w for l, w in lp["lin_res"].items()})
        feats = {l: m.get(l, 0) + res.get(l, 0) for l in feats}
        site_energies = site_energies + mlp_apply(params["readout"], feats[0][:, :, 0])
    return site_energies


def loss_fn(params, batch, cfg: MACEConfig) -> torch.Tensor:
    return common.task_loss(forward(params, batch, cfg), batch, cfg.task)
