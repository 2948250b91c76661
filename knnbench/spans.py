"""Span arithmetic for the readers of the program's own spans and counters
(``repro_torch.trace``): the intervals of a named span in a traced window,
their length, the device's idle time inside them, and a counter of the last
call.

A span or counter the program does not keep (an older program, or a run of
the other loop) gives nothing, and its readers read nothing.
"""
from __future__ import annotations

import bisect

from knnbench.yardstick import Trace

QUERY_BATCH = "repro_torch.query_batch"
GATHER_BATCH = "repro_torch.gather_batch"
UPLOAD = "repro_torch.upload"
BUILD = "repro_torch.build_knn_tables"
OBJECT_EXTRAS = "repro_torch.object_extras"
SWEEPS = ("repro_torch.run_sweep.up", "repro_torch.run_sweep.down")


def traced(run, kind: str) -> Trace | None:
    """The run's trace, where it is a traced run of the loop ``kind``."""
    if run.kind != kind or run.trace is None or not run.traced_ops:
        return None
    return run.trace


def intervals(trace: Trace, name: str, inside: str | None = None) -> list[tuple[float, float]]:
    """(start, end) of each host event ``name``, only those lying within an
    event ``inside`` where that is given."""
    found = [(s, e) for n, s, e in trace.host if n == name]
    if inside is not None:
        outer = intervals(trace, inside)
        found = [(s, e) for s, e in found if any(a <= s and e <= b for a, b in outer)]
    return found


def length(spans: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in spans)


def idle_s(trace: Trace, spans: list[tuple[float, float]]) -> float:
    """Seconds inside the union of ``spans`` in which no operation ran on the
    device (``Trace.busy_intervals``)."""
    busy = trace.busy_intervals()
    ends = [e for _, e in busy]
    idle = 0.0
    for s, e in _union(spans):
        covered = 0.0
        for bs, be in busy[bisect.bisect_right(ends, s):]:
            if bs >= e:
                break
            covered += min(e, be) - max(s, bs)
        idle += (e - s) - covered
    return idle


def last_count(span: str, key: str) -> int | None:
    """Counter ``key`` of the program's last completed outermost ``span``
    (``repro_torch.trace.last``), or None where the program keeps none."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.last(span).get(key)


def per_op_ms(run, seconds: float) -> float:
    """Milliseconds an operation: ``seconds`` over the traced window's operations."""
    return 1e3 * seconds / len(run.traced_ops)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]
