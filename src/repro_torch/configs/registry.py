"""Architecture registry of the port: ``--arch <id>`` for the eleven
architectures it runs (the kNN index, xdeepfm, five LMs and four GNNs), each
with its family (which entry point serves or trains it) and its shape set
(``configs.common``), whose (arch, shape) pairs are the cells of the dry run
(``all_cells``). A GNN's ``make_config`` takes the name of a shape of
``configs.common.gnn_shapes()``, as in the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (
    egnn,
    gcn_cora,
    granite_moe_1b_a400m,
    internlm2_20b,
    knn_index,
    llama4_scout_17b_a16e,
    mace,
    nequip,
    qwen1_5_110b,
    qwen2_5_3b,
    xdeepfm,
)
from repro_torch.configs.common import gnn_shapes, lm_shapes, recsys_shapes


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "knn" | "lm" | "recsys" | "gnn"
    make_config: Callable
    make_smoke: Callable
    shapes: dict  # shape name -> cell


def _lm(arch_id: str, mod) -> ArchSpec:
    return ArchSpec(arch_id, "lm", mod.make_config, mod.make_smoke,
                    lm_shapes(full_attention=True))


def _gnn(arch_id: str, mod) -> ArchSpec:
    return ArchSpec(arch_id, "gnn", mod.make_config, mod.make_smoke, gnn_shapes())


_ARCHS = {
    a.arch_id: a
    for a in [
        ArchSpec("knn-index", "knn", knn_index.make_config, knn_index.make_smoke,
                 knn_index.SHAPES),
        ArchSpec("xdeepfm", "recsys", xdeepfm.make_config, xdeepfm.make_smoke,
                 recsys_shapes(39, xdeepfm._BAG)),
        _lm("granite-moe-1b-a400m", granite_moe_1b_a400m),
        _lm("llama4-scout-17b-a16e", llama4_scout_17b_a16e),
        _lm("qwen2.5-3b", qwen2_5_3b),
        _lm("internlm2-20b", internlm2_20b),
        _lm("qwen1.5-110b", qwen1_5_110b),
        _gnn("egnn", egnn),
        _gnn("gcn-cora", gcn_cora),
        _gnn("nequip", nequip),
        _gnn("mace", mace),
    ]
}

# the cells of the assignment; the kNN index's two are the paper's own
ASSIGNED = [a for a in _ARCHS if a != "knn-index"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]


def all_archs() -> list[ArchSpec]:
    return list(_ARCHS.values())


def all_cells(include_skipped: bool = False):
    """Every (arch, shape, cell); a skipped cell carries its reason."""
    return [(a, shape, cell) for a in _ARCHS.values() for shape, cell in a.shapes.items()
            if include_skipped or not cell.skip]
