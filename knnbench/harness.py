"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix in ``traffic/<mix>.json``, the loop
the mix names in ``loops/<loop>.py`` (see ``loops/__init__.py``), and a
reader ``metrics/<metric>.py`` for each metric but ``setup_s``, which is the
harness's own. The window is a closed loop: the loop's operation, then a
synchronize, timed on the host's clock; this module knows no loop and no
metric by name.

Nothing here imports JAX or the JAX package, and the program is reached
only through its module attributes, so a test can plant a fault under it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from knnbench import bncache, generator
from knnbench.spec import (CACHE, PKG, ROOT, SRC, Cell, load_cell,  # noqa: F401 (re-exported)
                           network_params)
from knnbench.data import road
from knnbench.yardstick import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_WINDOW = "knnbench.traced_window"


def load_reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``: the metric's value, or
    None where the run holds nothing to read."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"knnbench_metric_{abs(hash(metric))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_loop(name: str):
    """The ``Loop`` class of ``loops/<name>.py``."""
    return importlib.import_module(f"knnbench.loops.{name}").Loop


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Op:
    """One timed operation of the window (host clock, seconds)."""

    start: float
    enqueued: float
    end: float
    pool: int
    items: int    # requests the operation answered


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    kind: str                   # the loop's name
    ops: list[Op]
    traced_ops: list[Op]
    trace: Trace | None
    least_s: dict[int, float]   # least device seconds of one op, by pool index
    window_s: float


class Reservoir:
    """A uniform sample of ``size`` of the window's operations, drawn from the seed."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.items[slot] = item
        self.seen += 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_network(cfg: dict) -> road.Network:
    return road.road_network(**network_params(cfg))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
             t_process: float, log=print, cache_dir: Path = CACHE,
             loader: bncache.Loader | None = None) -> tuple[dict, dict]:
    """Set up, measure for ``seconds``, trace when asked, judge. Returns the
    result (without its checks) and the checks: name -> (value, limit).
    ``loader``: the cached BN-Graph's read, when the caller started it."""
    from knnbench.reference.bellman import Bellman
    from knnbench.reference.dijkstra import Dijkstra
    from knnbench.reference.judge import LIMITS

    cfg, mix = cell.cfg, cell.mix
    marks = {"start": time.perf_counter()}
    if loader is None:
        loader = bncache.Loader(bncache.cache_path(cache_dir, SRC, network_params(cfg)))
    net = make_network(cfg)
    marks["network"] = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    marks["device"] = time.perf_counter()
    loader.result()
    marks["bngraph_read"] = time.perf_counter()
    bn, built_s = bncache.bngraph(loader, net, log)
    marks["bngraph"] = time.perf_counter()
    kind = mix["loop"]
    loop = load_loop(kind)(cell, bn, net.n, seed, dev)
    marks["loop"] = time.perf_counter()
    loop.warm(dev)
    if trace:  # the profiler's first start (seconds, the device tracer's set-up) is set-up too
        with torch.profiler.profile(activities=_activities(dev)):
            loop.op(0)
            _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    sample = Reservoir(loop.sample_size, generator.stream(seed, "sample"))
    ops: list[Op] = []
    traced: list[Op] = []
    prof = None
    trace_from, trace_cap = 0.25 * seconds, int(mix["trace_ops"])
    t_start = marks["warm"] = time.perf_counter()
    setup_s = t_start - t_process
    at, phases = t_process, {}
    for name, t in marks.items():
        phases[name], at = t - at, t
    log({"setup_phases_s": phases})
    i = 0
    while True:
        t0 = time.perf_counter()
        if i and t0 - t_start >= seconds:
            break
        if trace and prof is None and not traced and t0 - t_start >= trace_from:
            prof = torch.profiler.profile(activities=_activities(dev))
            prof.__enter__()
            mark = torch.profiler.record_function(TRACE_WINDOW)
            mark.__enter__()
            t0 = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(f"knnbench.{kind}"):
                j, out, items = loop.op(i)
            t_enq = time.perf_counter()
            with torch.profiler.record_function("knnbench.synchronize"):
                _sync(dev)
        else:
            j, out, items = loop.op(i)
            t_enq = time.perf_counter()
            _sync(dev)
        op = Op(t0, t_enq, time.perf_counter(), j, items)
        ops.append(op)
        if prof is not None:
            traced.append(op)
            if len(traced) >= trace_cap or op.end - traced[0].start >= 0.5 * seconds:
                mark.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                trace_prof, prof = prof, None
        sample.offer((j, out))
        out = None
        i += 1
    window_s = ops[-1].end - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if prof is not None:  # the window closed first
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        trace_prof = prof

    result: dict = {"attempted": sum(o.items for o in ops), "failed": 0}
    lat_ms = [1e3 * (o.end - o.start) for o in ops]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    log({"window_s": window_s, "ops": len(ops), "setup_s": setup_s, "bngraph_built_s": built_s,
         "latency_ms_median": statistics.median(lat_ms)})

    metrics: dict = {}
    if trace:
        parsed = _read_trace(trace_prof) if traced else None
        run = Run(kind, ops, traced, parsed, loop.least_s(net.n, {o.pool for o in traced}),
                  window_s)
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if parsed is not None and parsed.device:
            device["busy_s"] = parsed.busy_s
            device["window_s"] = parsed.window_s
            result["breakdown"] = {"device_ops": parsed.top_ops(), "idle_gaps": parsed.idle_gaps()}
    else:
        run = Run(kind, ops, [], None, {}, window_s)
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else load_reader(m["name"])(run)
            if value is None:
                raise RuntimeError(f"{cell.name}: the end-to-end metric {m['name']} read nothing")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device

    # the check, after the window, once the peak is read
    samples = sample.items
    sample = None
    bell = Bellman(net.indptr, net.indices, net.weights, dev)
    dij = Dijkstra(net.indptr, net.indices, net.weights)
    numbers = loop.judge(bell, dij, samples, generator.stream(seed, "picks"))
    checks = {name: (value, LIMITS[name]) for name, value in numbers.items()}
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result, checks


def _activities(dev: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _read_trace(prof) -> Trace | None:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="knnbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_chrome(path, TRACE_WINDOW)
    finally:
        os.remove(path)
