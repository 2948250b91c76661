"""Logical meshes: the port of ``repro/launch/mesh.py``.

The JAX package lays its cells on a ``jax.sharding.Mesh`` of TPU chips (16 x
16 a pod, 2 x 16 x 16 over two pods). One card has no mesh to place arrays
on, so the port keeps the mesh as arithmetic: a ``LogicalMesh`` is its axis
names and sizes and the ids of the devices it would hold, which is what
``distributed/sharding.py`` and ``distributed/elastic.py`` compute with.
Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    shape: dict[str, int]          # axis name -> size, in axis order
    device_ids: tuple[int, ...]    # the devices, row-major over the axes

    def __post_init__(self):
        if len(self.device_ids) != self.size:
            raise ValueError(f"a {dict(self.shape)} mesh holds {self.size} devices, "
                             f"given {len(self.device_ids)}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices(self) -> np.ndarray:
        """The device ids laid out over the axes."""
        return np.asarray(self.device_ids).reshape(tuple(self.shape.values()))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> LogicalMesh:
    return LogicalMesh(dict(zip(axes, shape)), tuple(range(math.prod(shape))))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a leading pod axis."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> LogicalMesh:
    """A small mesh over the devices there are: the cards, or one on the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    data = min(data, n)
    model = max(1, min(model, n // max(1, data)))
    return make_mesh((data, model), ("data", "model"))
