"""Sharding rules over a logical mesh: the port of
``repro/distributed/sharding.py``.

A ``ShardingRules`` names the mesh axes each kind of parallelism uses:
``fsdp`` (parameters and optimizer state fully sharded, ZeRO-3 style),
``tp`` (tensor parallelism over heads, FFN, experts and vocabulary) and
``batch`` (the global batch). Its sizes and divisibility tests are the JAX
package's arithmetic over a ``launch.mesh.LogicalMesh``.

On one card nothing is placed: ``constrain`` returns its input (the seam
where a multi-card port would place or reshard), and ``sharding`` raises,
since a placement on a mesh (a ``NamedSharding``) has no one-card
counterpart.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import LogicalMesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: LogicalMesh
    fsdp: tuple[str, ...] | str | None
    tp: str | None
    batch: tuple[str, ...] | str | None

    def _size(self, axis) -> int:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        return int(math.prod(self.mesh.shape[a] for a in axes))

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self._size(self.tp)

    @property
    def fsdp_size(self) -> int:
        return 1 if self.fsdp is None else self._size(self.fsdp)

    @property
    def batch_size_divisor(self) -> int:
        return 1 if self.batch is None else self._size(self.batch)

    def heads_axis(self, n_heads: int):
        return self.tp if (self.tp and n_heads % self.tp_size == 0) else None

    def ax(self, axis, dim: int):
        """``axis`` if it evenly divides ``dim``, else None."""
        if axis is None:
            return None
        return axis if dim % self._size(axis) == 0 else None

    def constrain(self, x, spec):
        """The JAX package's sharding constraint: on one card, ``x`` itself."""
        return x

    def sharding(self, spec):
        raise NotImplementedError(
            f"a placement on the {dict(self.mesh.shape)} mesh ({spec!r}) has no "
            "one-card counterpart")


def make_rules(mesh: LogicalMesh) -> ShardingRules:
    """Default rules for a (pod?, data, model) mesh."""
    names = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in names) or None
    tp = "model" if "model" in names else None
    return ShardingRules(mesh=mesh, fsdp=batch, tp=tp, batch=batch)


def divisible_fsdp_axis(rules: ShardingRules, dim: int):
    """The fsdp axes only when they divide ``dim`` (odd embedding rows)."""
    return rules.fsdp if dim % max(1, rules.fsdp_size) == 0 else None
