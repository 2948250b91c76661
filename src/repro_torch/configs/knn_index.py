"""The paper's own configuration: KNN-Index over a USA-scale road network.

  build_sweep : one level-synchronous construction step at full scale
                (n = 2^24 vertices ~ USA's 23.9M, k = 20 = the paper's
                default, level batch 131072, tau = 32 > every Table-2 tau)
  serve_batch : 2^20 concurrent kNN queries against the index

These are the shapes the on-card kernel check runs at. ``SHAPES`` are the
two cells of the dry run (``configs/registry.py``), with the JAX package's
input specs.
"""
import dataclasses

import torch

from repro_torch.configs.common import ShapeCell


@dataclasses.dataclass(frozen=True)
class KNNIndexConfig:
    name: str
    n_vertices: int = 1 << 24
    k: int = 20
    level_batch: int = 131072
    tau: int = 32
    query_batch: int = 1 << 20


def make_config() -> KNNIndexConfig:
    return KNNIndexConfig(name="knn-index-usa")


def make_smoke() -> KNNIndexConfig:
    return KNNIndexConfig(
        name="knn-index-smoke", n_vertices=512, k=5, level_batch=64, tau=4, query_batch=32
    )


def _rows(n: int) -> int:
    """Index rows with the dummy pad row, padded to a multiple of 512 (the JAX
    package's 512-device multiple, kept so the counted shapes are its own)."""
    return ((n + 1 + 511) // 512) * 512


def _build_specs(cfg: KNNIndexConfig):
    s, t, k = cfg.level_batch, cfg.tau, cfg.k
    rows = _rows(cfg.n_vertices)
    return {
        "verts": ((s,), torch.int32),
        "nbr": ((s, t), torch.int32),
        "w": ((s, t), torch.float32),
        "extra_ids": ((s, k), torch.int32),
        "extra_d": ((s, k), torch.float32),
        "vk_ids": ((rows, k), torch.int32),
        "vk_d": ((rows, k), torch.float32),
    }


def _serve_specs(cfg: KNNIndexConfig):
    rows = _rows(cfg.n_vertices)
    return {
        "vk_ids": ((rows, cfg.k), torch.int32),
        "vk_d": ((rows, cfg.k), torch.float32),
        "queries": ((cfg.query_batch,), torch.int32),
    }


SHAPES = {
    "build_sweep": ShapeCell("knn_build", _build_specs),
    "serve_batch": ShapeCell("knn_serve", _serve_specs),
}
