"""Unified partition-layout surface: ``PartitionPlan`` + the range splitter.

The JAX package's ``repro.core.partition``, copied (numpy only): the same
specs parse to the same plans, the same misuse raises the same typed
``EngineConfigError``, and ``propose_starts`` cuts the same boundaries.
``PartitionPlan`` is the one value object every layout-accepting entry point
takes:

    plan = PartitionPlan.parse("shards=4,replicate=auto:2,ranges=auto")
    engine = knn.build_sharded_engine(bn, objects, k, plan=plan)

* ``shards``: shard count (None = one shard: the port runs every shard on
  one card, see ``repro_torch.core.sharded``).
* ``ranges``: ``None`` (equal-width), ``"auto"`` (histogram-driven: object
  density at build time, the sliding query histogram in serve.py), or an
  explicit tuple of sorted start boundaries, one per shard, first 0.
* ``replication``: ``None``, an ``("auto", R)`` marker (serve.py's hottest
  shard watcher picks the shard), or normalized ``((shard, extras), ...)``
  pairs. ``()`` force-drops a plan an artifact saved.
* ``policy``: replica routing policy (``round_robin`` /
  ``least_outstanding``).

The legacy ``shards=`` / ``replication=`` kwargs construct a plan through
``PartitionPlan.resolve``; mixing a plan with them is an
``EngineConfigError``, not a silent override.

``propose_starts`` is the histogram-driven splitter: cumulative-weight
quantile cuts over a per-vertex weight vector (query counts, object
density), strictly-increasing boundaries enforced, so every shard gets a
non-empty range whose weight share is as close to ``1/shards`` as the
histogram allows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.errors import EngineConfigError

ROUTE_POLICIES = ("round_robin", "least_outstanding")

_SPEC_KEYS = ("shards", "replicate", "ranges", "policy")


@dataclass(frozen=True)
class PartitionPlan:
    """One value object for the whole partition layout (see module doc)."""

    shards: int | None = None
    ranges: tuple[int, ...] | str | None = None
    replication: tuple | None = None
    policy: str = "round_robin"

    def __post_init__(self):
        if self.shards is not None:
            if not isinstance(self.shards, (int, np.integer)) or int(self.shards) < 1:
                raise EngineConfigError(
                    f"PartitionPlan.shards must be a positive int or None, "
                    f"got {self.shards!r}"
                )
            object.__setattr__(self, "shards", int(self.shards))
        object.__setattr__(self, "ranges", self._norm_ranges(self.ranges))
        object.__setattr__(self, "replication", self._norm_replication(self.replication))
        if self.policy not in ROUTE_POLICIES:
            raise EngineConfigError(
                f"unknown replica routing policy {self.policy!r} "
                f"(want one of {ROUTE_POLICIES})"
            )
        if isinstance(self.ranges, tuple):
            if self.shards is None:
                object.__setattr__(self, "shards", len(self.ranges))
            elif self.shards != len(self.ranges):
                raise EngineConfigError(
                    f"PartitionPlan names {self.shards} shards but "
                    f"{len(self.ranges)} range boundaries"
                )

    def _norm_ranges(self, ranges):
        if ranges is None or ranges == "auto":
            return ranges
        if ranges == "equal":
            return None
        if isinstance(ranges, str):
            raise EngineConfigError(
                f"PartitionPlan.ranges must be None, 'auto', 'equal' or a "
                f"tuple of start boundaries, got {ranges!r}"
            )
        starts = tuple(int(s) for s in ranges)
        if not starts or starts[0] != 0:
            raise EngineConfigError(
                f"range boundaries must start at vertex 0, got {starts!r}"
            )
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise EngineConfigError(
                f"range boundaries must be strictly increasing, got {starts!r}"
            )
        return starts

    def _norm_replication(self, rep):
        if rep is None:
            return None
        if isinstance(rep, tuple) and len(rep) == 2 and rep[0] == "auto":
            extras = int(rep[1])
            if extras < 1:
                raise EngineConfigError(
                    f"auto-replication count must be >= 1, got {extras}"
                )
            return ("auto", extras)
        if isinstance(rep, dict):
            rep = sorted(rep.items())
        pairs = []
        for item in rep:
            s, r = item
            s, r = int(s), int(r)
            if s < 0:
                raise EngineConfigError(f"replication names negative shard {s}")
            if r < 0:
                raise EngineConfigError(
                    f"replica count for shard {s} must be >= 0, got {r}"
                )
            pairs.append((s, r))
        return tuple(sorted(pairs))

    # -- construction shims ---------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "PartitionPlan":
        """Parse a ``--partition`` SPEC string, e.g.
        ``shards=4,replicate=auto:2,ranges=auto`` or
        ``shards=3,ranges=0:100:700,policy=least_outstanding``."""
        kw: dict = {}
        for field in filter(None, (f.strip() for f in str(spec).split(","))):
            if "=" not in field:
                raise EngineConfigError(
                    f"partition spec field {field!r} is not key=value "
                    f"(keys: {', '.join(_SPEC_KEYS)})"
                )
            key, val = (p.strip() for p in field.split("=", 1))
            if key not in _SPEC_KEYS:
                raise EngineConfigError(
                    f"unknown partition spec key {key!r} "
                    f"(keys: {', '.join(_SPEC_KEYS)})"
                )
            if key in kw:
                raise EngineConfigError(f"duplicate partition spec key {key!r}")
            try:
                if key == "shards":
                    kw["shards"] = int(val)
                elif key == "policy":
                    kw["policy"] = val
                elif key == "ranges":
                    kw["ranges"] = (
                        val if val in ("auto", "equal")
                        else tuple(int(b) for b in val.split(":"))
                    )
                else:  # replicate=auto:R | SHARD:R
                    shard, extras = val.split(":", 1)
                    kw["replication"] = (
                        ("auto", int(extras)) if shard == "auto"
                        else ((int(shard), int(extras)),)
                    )
            except EngineConfigError:
                raise
            except ValueError as e:
                raise EngineConfigError(
                    f"cannot parse partition spec field {field!r}: {e}"
                ) from None
        return cls(**kw)

    @classmethod
    def resolve(
        cls,
        plan: "PartitionPlan | str | None",
        *,
        shards: int | None = None,
        replication=None,
        policy: str | None = None,
    ) -> "PartitionPlan":
        """Merge point for the legacy kwargs: either a plan OR the old
        ``shards=``/``replication=`` kwargs, never both."""
        if isinstance(plan, str):
            plan = cls.parse(plan)
        if plan is not None:
            if shards is not None or replication is not None or policy is not None:
                raise EngineConfigError(
                    "pass either plan= or the legacy shards=/replication= "
                    "kwargs, not both"
                )
            return plan
        rep = None
        if replication is not None:
            # legacy {} means "force-drop a saved plan": keep it distinct
            # from None (= no opinion) as the empty pair tuple
            rep = tuple(sorted((int(s), int(r)) for s, r in replication.items()))
        return cls(
            shards=shards, replication=rep,
            policy="round_robin" if policy is None else policy,
        )

    # -- consumers -------------------------------------------------------

    def replication_dict(self) -> dict[int, int] | None:
        """The explicit shard -> extras plan, ``{}`` for a force-drop, or
        None when unset / deferred to the ``auto`` watcher."""
        if self.replication is None or self.auto_replicas():
            return None
        return {s: r for s, r in self.replication}

    def auto_replicas(self) -> int:
        """Replica count of an ``("auto", R)`` marker, else 0."""
        if (
            isinstance(self.replication, tuple)
            and len(self.replication) == 2
            and self.replication[0] == "auto"
        ):
            return int(self.replication[1])
        return 0

    def describe(self) -> dict:
        """JSON-friendly view of the plan (serve.py stats reporting)."""
        ranges = self.ranges
        if isinstance(ranges, tuple):
            ranges = list(ranges)
        rep = self.replication
        if self.auto_replicas():
            rep = f"auto:{self.auto_replicas()}"
        elif rep is not None:
            rep = {str(s): r for s, r in rep}
        return {
            "shards": self.shards,
            "ranges": "equal" if ranges is None else ranges,
            "replication": rep,
            "policy": self.policy,
        }


def propose_starts(
    weights, num_shards: int, *, n: int | None = None
) -> np.ndarray:
    """Balanced shard-start boundaries from a per-vertex weight histogram.

    Cuts the cumulative weight curve at the ``i/num_shards`` quantiles —
    each shard's range carries as close to ``1/num_shards`` of the total
    weight as whole vertices allow — then clamps the cuts to strictly
    increasing boundaries so every shard keeps a non-empty range even when
    the histogram collapses onto a few vertices. A zero (or empty) histogram
    degenerates to the equal-width split.
    """
    w = np.asarray(weights, np.float64).reshape(-1)
    if n is None:
        n = len(w)
    elif len(w) != n:
        raise EngineConfigError(
            f"weight histogram has {len(w)} entries for n={n} vertices"
        )
    num_shards = int(num_shards)
    if not 1 <= num_shards <= max(n, 1):
        raise EngineConfigError(
            f"cannot split n={n} vertices into {num_shards} shards"
        )
    if w.size and (not np.all(np.isfinite(w)) or np.any(w < 0)):
        raise EngineConfigError("weights must be finite and non-negative")
    starts = np.zeros(num_shards, np.int64)
    if not w.size or float(w.sum()) <= 0.0:
        rows = -(-n // num_shards)  # ceil: the equal-width fallback
        return np.minimum(
            np.arange(num_shards, dtype=np.int64) * rows,
            np.arange(num_shards, dtype=np.int64) + n - num_shards,
        )
    c = np.cumsum(w)
    targets = c[-1] * np.arange(1, num_shards, dtype=np.float64) / num_shards
    cuts = np.searchsorted(c, targets, side="left") + 1
    for i, cut in enumerate(cuts, start=1):
        lo = int(starts[i - 1]) + 1           # strictly increasing
        hi = n - (num_shards - i)             # room for the shards after
        starts[i] = min(max(int(cut), lo), hi)
    return starts
