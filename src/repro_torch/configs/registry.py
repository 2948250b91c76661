"""Architecture registry of the port: ``--arch <id>`` for the three
architectures it runs, each with its family (which driver serves it)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import knn_index, qwen2_5_3b, xdeepfm


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "knn" | "lm" | "recsys"
    make_config: Callable
    make_smoke: Callable


_ARCHS = {
    a.arch_id: a
    for a in [
        ArchSpec("knn-index", "knn", knn_index.make_config, knn_index.make_smoke),
        ArchSpec("xdeepfm", "recsys", xdeepfm.make_config, xdeepfm.make_smoke),
        ArchSpec("qwen2.5-3b", "lm", qwen2_5_3b.make_config, qwen2_5_3b.make_smoke),
    ]
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]
