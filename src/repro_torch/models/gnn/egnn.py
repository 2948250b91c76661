"""EGNN (Satorras et al., arXiv:2102.09844), E(n)-equivariant message passing:
the port of ``repro/models/gnn/egnn.py`` (assigned config: 4 layers, hidden
64).

Messages are built from invariants (h_i, h_j, |x_i - x_j|^2); coordinates
move along relative positions, which keeps each layer E(n)-equivariant. The
coordinate update divides by ``sqrt(d2) + 1`` as the reference does: at a
zero-length edge (a self loop, or a padded dummy edge) the derivative of
``sqrt`` is infinite, so from the second layer on, where ``x`` depends on the
parameters, the gradients come out NaN on both sides. The port reproduces
that and does not mend it (a "safe" sqrt would be a result the reference
does not give).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import generator, resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, normal
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16            # 0 -> species-embedding input
    n_out: int = 1              # per-graph scalar (energy) or per-node classes
    n_species: int = 16
    task: str = "energy"        # "energy" | "node_class"
    coord_update: bool = True
    param_dtype: torch.dtype = torch.float32


def init_params(cfg: EGNNConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = generator(resolve_device(device), seed)
    d, dt = cfg.d_hidden, cfg.param_dtype
    layers = [{"phi_e": mlp_init(gen, [2 * d + 1, d, d], dt),
               "phi_x": mlp_init(gen, [d, d, 1], dt),
               "phi_h": mlp_init(gen, [2 * d, d, d], dt)}
              for _ in range(cfg.n_layers)]
    if cfg.d_feat > 0:
        enc = mlp_init(gen, [cfg.d_feat, d], dt)
    else:
        enc = normal(gen, (cfg.n_species, d), 0.5, dt)
    return {"encoder": enc, "layers": layers, "readout": mlp_init(gen, [d, d, cfg.n_out], dt)}


def forward(params, batch, cfg: EGNNConfig):
    """batch: node_feat (n,F) or species (n,); pos (n,3); edge_index (2,E).
    Returns (per-node output, moved coordinates)."""
    src, dst = batch["edge_index"]
    n = batch["pos"].shape[0]
    if cfg.d_feat > 0:
        h = mlp_apply(params["encoder"], batch["node_feat"], final_act=True)
    else:
        h = common.take_rows(params["encoder"], batch["species"])
    x = batch["pos"].to(h.dtype)
    for lp in params["layers"]:
        rel = x[dst] - x[src]
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"], torch.cat([h[src], h[dst], d2], dim=-1), final_act=True)
        if cfg.coord_update:
            scale = mlp_apply(lp["phi_x"], m)
            upd = rel / (torch.sqrt(d2) + 1.0) * scale
            x = x + common.scatter_mean(upd, dst, n)
        agg = common.scatter_sum(m, dst, n)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], dim=-1))
    node_out = mlp_apply(params["readout"], h)
    return node_out, x


def loss_fn(params, batch, cfg: EGNNConfig) -> torch.Tensor:
    node_out, _ = forward(params, batch, cfg)
    return common.task_loss(node_out, batch, cfg.task)
