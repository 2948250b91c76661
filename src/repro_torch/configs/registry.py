"""Architecture registry of the port: ``--arch <id>`` for the eleven
architectures it runs (the kNN index, xdeepfm, five LMs and four GNNs), each
with its family (which entry point serves or trains it). A GNN's
``make_config`` takes the name of a shape of ``configs.common.gnn_shapes()``,
as in the JAX package."""
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


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "knn" | "lm" | "recsys" | "gnn"
    make_config: Callable
    make_smoke: Callable


_ARCHS = {
    a.arch_id: a
    for a in [
        ArchSpec("knn-index", "knn", knn_index.make_config, knn_index.make_smoke),
        ArchSpec("xdeepfm", "recsys", xdeepfm.make_config, xdeepfm.make_smoke),
        ArchSpec("granite-moe-1b-a400m", "lm", granite_moe_1b_a400m.make_config,
                 granite_moe_1b_a400m.make_smoke),
        ArchSpec("llama4-scout-17b-a16e", "lm", llama4_scout_17b_a16e.make_config,
                 llama4_scout_17b_a16e.make_smoke),
        ArchSpec("qwen2.5-3b", "lm", qwen2_5_3b.make_config, qwen2_5_3b.make_smoke),
        ArchSpec("internlm2-20b", "lm", internlm2_20b.make_config, internlm2_20b.make_smoke),
        ArchSpec("qwen1.5-110b", "lm", qwen1_5_110b.make_config, qwen1_5_110b.make_smoke),
        ArchSpec("egnn", "gnn", egnn.make_config, egnn.make_smoke),
        ArchSpec("gcn-cora", "gnn", gcn_cora.make_config, gcn_cora.make_smoke),
        ArchSpec("nequip", "gnn", nequip.make_config, nequip.make_smoke),
        ArchSpec("mace", "gnn", mace.make_config, mace.make_smoke),
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]
