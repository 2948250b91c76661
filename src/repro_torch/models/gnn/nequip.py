"""NequIP (Batzner et al., arXiv:2101.03164): O(3)-equivariant interatomic
potential by irreps tensor-product message passing, the port of
``repro/models/gnn/nequip.py`` (assigned config: 5 layers, 32 channels,
l_max = 2, 8 Bessel RBFs, cutoff 5).

Per edge, the CG tensor product of the source's features with the edge's
spherical harmonics, weighted per (path, channel) by a radial MLP and summed
into the destination; at l_max = 2 that is all 15 paths of ``cg_paths(2)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, normal
from repro_torch.models.gnn import common, irreps


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    d_feat: int = 0          # >0: dense node features instead of species
    n_out: int = 1
    task: str = "energy"     # "energy" | "node_class"
    param_dtype: torch.dtype = torch.float32


def _paths(cfg) -> list[tuple[int, int, int]]:
    return irreps.cg_paths(cfg.l_max)


def init_params(cfg: NequIPConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales (``lin_msg``
    and ``lin_self`` keyed "0", "1", ...), drawn on ``device`` from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    c, dt = cfg.d_hidden, cfg.param_dtype
    lin = lambda: {str(l): normal(gen, (c, c), c**-0.5, dt) for l in range(cfg.l_max + 1)}
    layers = [{"radial": mlp_init(gen, [cfg.n_rbf, 32, len(_paths(cfg)) * c], dt),
               "lin_msg": lin(), "lin_self": lin()}
              for _ in range(cfg.n_layers)]
    if cfg.d_feat > 0:
        enc = mlp_init(gen, [cfg.d_feat, c], dt)
    else:
        enc = normal(gen, (cfg.n_species, c), 0.5, dt)
    return {"encoder": enc, "layers": layers, "readout": mlp_init(gen, [c, c, cfg.n_out], dt)}


def _embed(params, batch, cfg):
    if cfg.d_feat > 0:
        s = mlp_apply(params["encoder"], batch["node_feat"], final_act=True)
    else:
        s = common.take_rows(params["encoder"], batch["species"])
    n = s.shape[0]
    feats = {0: s[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n, cfg.d_hidden, 2 * l + 1), dtype=s.dtype, device=s.device)
    return feats


def forward(params, batch, cfg: NequIPConfig) -> torch.Tensor:
    src, dst = batch["edge_index"]
    pos = batch["pos"]
    n = pos.shape[0]
    c = cfg.d_hidden
    rel = pos[dst] - pos[src]
    r = torch.linalg.vector_norm(rel, dim=-1)
    rbf = irreps.bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    ylm = irreps.sh(rel, cfg.l_max)
    paths = _paths(cfg)
    feats = _embed(params, batch, cfg)
    for lp in params["layers"]:
        radial = mlp_apply(lp["radial"], rbf)  # (E, P*c)
        radial = radial.reshape(radial.shape[0], len(paths), c)
        src_feats = {l: x[src] for l, x in feats.items()}
        path_w = {p: radial[:, i, :] for i, p in enumerate(paths)}
        msgs = irreps.tensor_product(src_feats, ylm, path_w, cfg.l_max)
        agg = {l: common.scatter_sum(m.reshape(m.shape[0], -1), dst, n).reshape(n, c, 2 * l + 1)
               for l, m in msgs.items()}
        mixed = irreps.linear_mix(agg, {int(l): w for l, w in lp["lin_msg"].items()})
        selfc = irreps.linear_mix(feats, {int(l): w for l, w in lp["lin_self"].items()})
        new = {l: mixed.get(l, 0) + selfc.get(l, 0) for l in feats}
        feats = irreps.gate(new)
    node_scalar = feats[0][:, :, 0]
    return mlp_apply(params["readout"], node_scalar)


def loss_fn(params, batch, cfg: NequIPConfig) -> torch.Tensor:
    return common.task_loss(forward(params, batch, cfg), batch, cfg.task)
