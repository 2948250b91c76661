"""The benchmark's yardstick: the card's data-sheet rates, the least time a
piece of work could take on it, and the reduction of a profiler trace to
busy time, kernel time and idle gaps.

Work is counted from the inputs and the BN-Graph's real neighbour slots,
never from what a kernel happens to do: each input byte read once, each
output byte written once, so a share of the roofline reads the same work
whatever implements it and cannot pass 100%.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at 700 W (as repro_torch/launch/op_cost.py)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, nops: float) -> float:
    """The larger of bytes over HBM bandwidth and operations over float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def serve_batch_bytes(us: np.ndarray, n: int, k: int) -> int:
    """One query batch: each query's vertex and k read (8 B), each table row
    the batch touches read once (8 B an entry), the (B, k) answer written."""
    touched = int(np.count_nonzero(np.bincount(us, minlength=n + 1)))
    return 8 * len(us) + 8 * k * touched + 8 * k * len(us)


def sweep_work(slots: int, rows: int, k: int) -> tuple[int, int]:
    """One sweep of K2 (``chip_smoke.py``'s rule): 8 B a real neighbour
    slot and 4 a row of schedule, each row's extras read once and its k
    entries written once; an add and a min a candidate (k a neighbour slot,
    k extras a row)."""
    nbytes = 8 * slots + 4 * rows + 2 * 8 * rows * k
    nops = 2 * (slots * k + rows * k)
    return nbytes, nops


@dataclasses.dataclass
class Trace:
    """Device and host events of one ``torch.profiler`` chrome trace, in
    seconds on the trace's clock, inside the traced window."""

    start: float
    end: float
    device: list[tuple[str, float, float]]   # (name, start, end)
    host: list[tuple[str, float, float]]     # (name, start, end): annotations and aten ops

    @classmethod
    def from_chrome(cls, path: str, window: str) -> "Trace | None":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in spans if e.get("name") == window and e.get("cat") == "user_annotation"]
        if not marks:
            return None
        start = marks[0]["ts"] * 1e-6
        end = start + marks[0]["dur"] * 1e-6

        def inside(e):
            s = e["ts"] * 1e-6
            return (e.get("name", ""), max(s, start), min(s + e["dur"] * 1e-6, end))

        device = [inside(e) for e in spans
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        host = [inside(e) for e in spans
                if e.get("cat") in ("cpu_op", "user_annotation") and e.get("name") != window]
        return cls(start, end, [x for x in device if x[2] > x[1]], [x for x in host if x[2] > x[1]])

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, name_part: str) -> float:
        """Device seconds of the kernels whose name holds ``name_part``."""
        return sum(e - s for name, s, e in self.device if name_part in name)

    def top_ops(self, count: int = 10) -> list[list]:
        """The device operations that took most time, by name."""
        total: dict[str, float] = {}
        for name, s, e in self.device:
            key = _short(name)
            total[key] = total.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list[list]:
        """Idle device time by what the host was doing at the gap's middle:
        the outermost annotation and the innermost host op open then."""
        gaps, at = [], self.start
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        host = sorted(self.host, key=lambda x: x[1])
        starts = np.array([h[1] for h in host])
        total: dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            open_ = [h for h in host[: int(np.searchsorted(starts, mid, side="right"))] if h[2] >= mid]
            if open_:
                outer = min(open_, key=lambda h: h[1])[0]
                inner = max(open_, key=lambda h: h[1])[0]
                key = outer if inner == outer else f"{outer} > {inner}"
            else:
                key = "no host span"
            total[key] = total.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:count]]


def _short(name: str) -> str:
    """A kernel's name without its parameter list (the trailing group in
    parentheses; "(anonymous namespace)::" and template arguments stay)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:96]
