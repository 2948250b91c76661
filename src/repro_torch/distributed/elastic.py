"""Elastic recovery arithmetic: the port of ``repro/distributed/elastic.py``.

After a loss of devices the JAX package rebuilds the largest mesh the
survivors make (the model axis kept whole, the data axis shrunk to a power
of two), restores the latest checkpoint under the new mesh's shardings and
resumes at its step. Here the mesh is a ``launch.mesh.LogicalMesh`` of
device ids: the shapes and axis names are the JAX package's, and the
restore is ``checkpoint/manager.restore`` (one card: nothing to re-place).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.launch.mesh import LogicalMesh


def surviving_mesh(devices: Sequence[int], model_axis: int, *, pod_axis: int = 1) -> LogicalMesh:
    """The largest (pod, data, model) mesh of the surviving ``devices``, the
    model axis kept at ``model_axis`` and the data axis the largest power of
    two that fits."""
    n = len(devices)
    if n < model_axis:
        raise ValueError(f"cannot keep model axis {model_axis} with {n} devices")
    data_axis = 1 << ((n // model_axis).bit_length() - 1)
    use = tuple(devices[: pod_axis * data_axis * model_axis])
    if pod_axis > 1:
        return LogicalMesh({"pod": pod_axis, "data": data_axis, "model": model_axis}, use)
    return LogicalMesh({"data": data_axis, "model": model_axis}, use)


def simulate_failures(devices: Sequence[int], lost: int) -> list:
    """Drop ``lost`` devices (the tail host's slice)."""
    return list(devices[: len(devices) - lost])


def global_batch_for(mesh: LogicalMesh, per_device_batch: int) -> int:
    """The per-device batch kept, the global batch tracking the surviving
    data-parallel width."""
    data = 1
    for ax in ("pod", "data"):
        data *= mesh.shape.get(ax, 1)
    return per_device_batch * data
