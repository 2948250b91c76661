"""The step timer and the on-pace quorum of synchronous training: the port's
own copy of ``StepTimer``, ``pace_flag`` and ``quorum_ok`` from
``repro/distributed/straggler.py``.

A host is on pace when its step finished within the deadline (the timer's
running mean times a tolerance); the fleet proceeds while at least ``quorum``
of the hosts are. The flags' exchange across hosts (one all-reduce a step)
is the caller's; on one card the flag is this process's own.
"""
from __future__ import annotations

import time

import torch


def pace_flag(step_start: float, deadline_s: float) -> torch.Tensor:
    """1.0 if this host hit its deadline, else 0.0 (host-side measurement)."""
    return torch.tensor(1.0 if (time.monotonic() - step_start) <= deadline_s else 0.0)


def quorum_ok(flags_mean, quorum: float = 0.95) -> bool:
    """The fleet proceeds when >= quorum of hosts are on pace."""
    return bool(flags_mean >= quorum)


class StepTimer:
    """EWMA of step wall time; deadline = mean * tolerance."""

    def __init__(self, tolerance: float = 1.5, alpha: float = 0.1):
        self.mean: float | None = None
        self.tolerance = tolerance
        self.alpha = alpha

    def update(self, dt: float) -> None:
        self.mean = dt if self.mean is None else (1 - self.alpha) * self.mean + self.alpha * dt

    @property
    def deadline(self) -> float:
        return float("inf") if self.mean is None else self.mean * self.tolerance
