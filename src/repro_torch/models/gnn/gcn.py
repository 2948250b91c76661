"""GCN (Kipf & Welling, arXiv:1609.02907), symmetric-normalised aggregation
with self loops: the port of ``repro/models/gnn/gcn.py`` (the gcn-cora
config: 2 layers, hidden 16)."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import normal
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433          # 0 -> species-embedding input
    n_classes: int = 7
    n_species: int = 16
    task: str = "node_class"    # "node_class" | "energy"
    param_dtype: torch.dtype = torch.float32


def init_params(cfg: GCNConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d0 = cfg.d_feat if cfg.d_feat > 0 else cfg.d_hidden
    dims = [d0] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    p = {"layers": [{"w": normal(gen, (a, b), a**-0.5, cfg.param_dtype)}
                    for a, b in zip(dims[:-1], dims[1:])]}
    if cfg.d_feat == 0:
        p["embed"] = normal(gen, (cfg.n_species, d0), 0.5, cfg.param_dtype)
    return p


def forward(params, batch, cfg: GCNConfig) -> torch.Tensor:
    """batch: node_feat (n, d_feat) or species (n,); edge_index (2, E)."""
    x = batch["node_feat"] if cfg.d_feat > 0 else common.take_rows(params["embed"],
                                                                    batch["species"])
    src, dst = batch["edge_index"]
    n = x.shape[0]
    deg = common.degree(dst, n, x.dtype) + 1.0  # +1: self loop normalisation
    norm = torch.rsqrt(deg)
    coef = (norm[src] * norm[dst])[:, None]
    for i, layer in enumerate(params["layers"]):
        h = x @ layer["w"].to(x.dtype)
        msg = h[src] * coef
        agg = common.scatter_sum(msg, dst, n) + h * (norm**2)[:, None]  # self loop
        x = F.relu(agg) if i < len(params["layers"]) - 1 else agg
    return x


def loss_fn(params, batch, cfg: GCNConfig) -> torch.Tensor:
    return common.task_loss(forward(params, batch, cfg), batch, cfg.task)
