"""Spans and counters inside the port, on the profiler's clock.

``span(name)`` marks a stretch of the serving, construction or flush path,
``count(key, n)`` adds ``n`` to a counter of the outermost span open at the
time, and ``last(name)`` gives the counters of the last completed call of
the outermost span ``name``.

A span enters ``torch.profiler.record_function(name)`` only while a profiler
session records (``torch.autograd.profiler._is_profiler_enabled``); with none
open it costs that one flag read and the bookkeeping the counters need. The
spans land in whatever ``torch.profiler`` session the caller opened, on the
clock of the session's kernel and copy events, so each idle gap of the
device can be put down to the span the host was in. Nothing here keeps a
timestamp, writes a trace or synchronizes the device.

To see the spans, open a profiler with CPU and CUDA activities around
serving or building, then export it::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ids, d = engine.query_batch(us)
        torch.cuda.synchronize()
    prof.export_chrome_trace("serve.json")   # chrome://tracing or Perfetto

The spans are the trace's ``user_annotation`` events named ``repro_torch.*``:

- ``repro_torch.query_batch``: ``EngineCore.query_batch``, the whole call;
  inside it ``repro_torch.gather_batch``, the engine's ``_gather_batch``
  (uploads, row gathers, mask);
- ``repro_torch.upload``: each host -> device crossing
  (``sanitize.upload``), under whatever span is open;
- ``repro_torch.build_knn_tables``: ``construct.build_knn_tables``, the
  whole call; inside it ``repro_torch.object_extras`` (host numpy, then its
  two uploads) and ``repro_torch.run_sweep.up`` / ``.down`` (each sweep's
  enqueue);
- ``repro_torch.flush_updates``: ``EngineCore.flush_updates``, the whole
  call; inside it, in order, ``repro_torch.flush.delete_scan``,
  ``repro_torch.flush.frontier`` (the checkIns rounds and the candidates'
  compaction), ``repro_torch.flush.purge_merge`` and
  ``repro_torch.flush.repair``.

Counters: ``h2d_bytes``, the bytes of every host array uploaded, so
``last("repro_torch.query_batch")["h2d_bytes"]`` is what the last batch sent
up; ``k2_gathered`` and ``k2_kept``, the candidates K2's sweeps gathered and
kept past their rows' bounds (``run_sweep``, on the card only);
``d2h_bytes``, the bytes of every device -> host readback
(``EngineCore._readback``); and, per flush, ``frontier_rounds``,
``repair_rounds``, ``rows_touched`` (the rows the checkIns frontier's state
touched) and ``k3_bytes`` (K3's least bytes over the flush's launches, on
the scalar engine). A counter
given a device tensor stays a tensor, summed on the device, so counting
never waits for the device; ``last`` turns it into an int. The counters
assume one thread drives the spans at a time, as the engines are driven.
"""
from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

_counts: dict[str, int | torch.Tensor] | None = None    # the outermost open span's counters
_last: dict[str, dict[str, int | torch.Tensor]] = {}


class span:
    """``with span(name):`` a program span, recorded while a profiler runs;
    the outermost one open also collects the counters of ``count``."""

    __slots__ = ("name", "_record", "_outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        global _counts
        self._outer = _counts is None
        if self._outer:
            _counts = {}
        if _profiler._is_profiler_enabled:
            self._record = _profiler.record_function(self.name)
            self._record.__enter__()
        else:
            self._record = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _counts
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
        if self._outer:
            if exc_type is None:
                _last[self.name] = _counts
            _counts = None


def count(key: str, n: int | torch.Tensor) -> None:
    """Add ``n`` to counter ``key`` of the outermost open span (none open:
    nothing is kept). A tensor ``n`` (one element) is added as a tensor,
    never read."""
    if _counts is not None:
        if not isinstance(n, torch.Tensor):
            n = int(n)
        prev = _counts.get(key)
        _counts[key] = n if prev is None else prev + n


def last(name: str) -> dict[str, int]:
    """The counters of the last call of the outermost span ``name`` that
    completed without raising, as ints (a device counter is read here, which
    waits for the device); empty before the first."""
    return {key: int(n) for key, n in _last.get(name, {}).items()}
