"""The readers of the program's own spans and counters (``knnbench/spans.py``
and the metrics that use it): span time, self time and device idle inside a
span on hand-made traces, nothing on the other loop or from a program that
keeps no such span, and a value for every one of them in a tiny traced run."""
from __future__ import annotations

import sys

import pytest

from knnbench import harness, spans
from knnbench.tests.helpers import run_tiny, tiny_cell
from knnbench.yardstick import Trace

US = 1e-6
SERVE = ("serve_engine_self_ms", "serve_upload_ms", "serve_gather_enqueue_ms",
         "serve_idle_in_upload_ms", "serve_h2d_bytes")
BUILD = ("build_extras_ms", "build_sweep_enqueue_ms", "build_idle_in_extras_ms",
         "build_h2d_bytes")


def _read(name, run):
    return harness.load_reader(name)(run)


def _serve_trace() -> Trace:
    """Two batches; times in microseconds. Batch 1: query_batch [1, 39),
    gather [5, 38), uploads [6, 12) and [14, 20); the device copies in
    [10, 12) and computes in [18, 30). Batch 2 the same shifted by 50, with
    the device busy in [60, 75)."""
    host = []
    for t0 in (0, 50):
        host += [("knnbench.serve", t0, t0 + 40), (spans.QUERY_BATCH, t0 + 1, t0 + 39),
                 (spans.GATHER_BATCH, t0 + 5, t0 + 38), (spans.UPLOAD, t0 + 6, t0 + 12),
                 ("aten::copy_", t0 + 7, t0 + 11), (spans.UPLOAD, t0 + 14, t0 + 20)]
    host.append((spans.UPLOAD, 92, 95))   # an upload outside any batch: not the batch's
    device = [("Memcpy HtoD", 10, 12), ("gather(long)", 18, 30), ("gather(long)", 60, 75)]
    return Trace(0.0, 100 * US, [(n, s * US, e * US) for n, s, e in device],
                 [(n, s * US, e * US) for n, s, e in host])


def _build_trace() -> Trace:
    """One build: build_knn_tables [0, 90), extras [1, 31) with its uploads
    [20, 25) and [26, 31), the sweeps' enqueue [31, 33) and [33, 34); the
    device copies in [22, 31) and sweeps in [32, 88)."""
    host = [("knnbench.build", 0, 95), (spans.BUILD, 0, 90), (spans.OBJECT_EXTRAS, 1, 31),
            (spans.UPLOAD, 20, 25), (spans.UPLOAD, 26, 31), (spans.SWEEPS[0], 31, 33),
            (spans.SWEEPS[1], 33, 34)]
    device = [("Memcpy HtoD", 22, 31), ("sweep_levels_kernel(int)", 32, 88)]
    return Trace(0.0, 100 * US, [(n, s * US, e * US) for n, s, e in device],
                 [(n, s * US, e * US) for n, s, e in host])


def _run(kind, trace, traced=2):
    ops = [harness.Op(0.0, 0.0, 0.0, 0, 1) for _ in range(traced)]
    return harness.Run(kind, ops, ops, trace, {}, 1.0)


def test_serve_span_readers_on_a_hand_made_trace():
    run = _run("serve", _serve_trace())
    ms = 1e-3  # a microsecond in milliseconds
    # query_batch 38 less gather 33, twice, over 2 batches
    assert _read("serve_engine_self_ms", run) == pytest.approx(5 * ms)
    # the uploads inside a batch: 6 + 6 a batch (the one at 92 is outside)
    assert _read("serve_upload_ms", run) == pytest.approx(12 * ms)
    # gather 33 less its uploads 12
    assert _read("serve_gather_enqueue_ms", run) == pytest.approx(21 * ms)
    # idle inside uploads: [6, 10) and [14, 18); [56, 60) and none in [64, 70)
    assert _read("serve_idle_in_upload_ms", run) == pytest.approx(12 / 2 * ms)
    # the three parts add up to the query_batch span
    parts = sum(_read(name, run) for name in SERVE[:3])
    assert parts == pytest.approx(38 * ms)


def test_build_span_readers_on_a_hand_made_trace():
    run = _run("build", _build_trace(), traced=1)
    ms = 1e-3
    assert _read("build_extras_ms", run) == pytest.approx(30 * ms)
    assert _read("build_sweep_enqueue_ms", run) == pytest.approx(3 * ms)
    # extras [1, 31) less the copy [22, 31)
    assert _read("build_idle_in_extras_ms", run) == pytest.approx(21 * ms)


def test_idle_inside_overlapping_spans_counts_once():
    trace = Trace(0.0, 10.0, [("k", 2.0, 3.0), ("k", 2.5, 6.0), ("k", 8.0, 9.0)], [])
    assert spans.idle_s(trace, [(0.0, 4.0), (1.0, 7.0), (7.5, 10.0)]) == pytest.approx(
        (7.0 - 4.0) + (10.0 - 7.5 - 1.0))
    assert spans.idle_s(trace, []) == 0.0


def test_readers_read_nothing_on_the_other_loop_or_without_the_spans(monkeypatch):
    for name in SERVE:
        assert _read(name, _run("build", _build_trace())) is None
    for name in BUILD:
        assert _read(name, _run("serve", _serve_trace())) is None
    # a program without spans: its trace holds none of them
    bare = Trace(0.0, 1.0, [("k", 0.1, 0.2)], [("knnbench.serve", 0.0, 0.5)])
    for name in SERVE[:4]:
        assert _read(name, _run("serve", bare)) is None
    for name in BUILD[:3]:
        assert _read(name, _run("build", bare)) is None
    # a program without the counters' module
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert _read("serve_h2d_bytes", _run("serve", bare)) is None
    assert _read("build_h2d_bytes", _run("build", bare)) is None


def test_device_readers_read_nothing_without_device_work():
    host_only = _serve_trace()
    host_only.device = []
    assert _read("serve_idle_in_upload_ms", _run("serve", host_only)) is None
    assert _read("serve_upload_ms", _run("serve", host_only)) is not None


def test_counter_readers_read_the_programs_last_call():
    from repro_torch import trace

    with trace.span(spans.QUERY_BATCH):
        trace.count("h2d_bytes", 8 * 1024)
    with trace.span(spans.BUILD):
        trace.count("h2d_bytes", 40)
    assert _read("serve_h2d_bytes", _run("serve", _serve_trace())) == 8 * 1024
    assert _read("build_h2d_bytes", _run("build", _build_trace())) == 40
    untraced = harness.Run("serve", [], [], None, {}, 1.0)
    assert _read("serve_h2d_bytes", untraced) is None


@pytest.mark.parametrize("name", ["k20-serve", "k20-build"])
def test_a_tiny_traced_run_gives_every_span_and_counter_metric(name, tmp_path):
    cell = tiny_cell(name)
    # a window long enough that operations run after the trace's start at a
    # quarter of it, however loaded the host
    result, _ = run_tiny(cell, tmp_path, trace=True, seconds=3.0)
    assert result["correct"]
    metrics = {m: v["value"] for m, v in result["metrics"].items()}
    ours = set(SERVE if name.endswith("serve") else BUILD)
    idle = {m for m in ours if "_idle_" in m}
    wanted = {m["name"] for m in cell.per_layer
              if m["source"] in ("program_span", "program_counter")}
    # every span and counter metric of the cell is this file's but the
    # benchmark's own enqueue span; on the CPU the device-idle ones stay silent
    assert wanted == ours - idle | {f"{cell.mix['loop']}_enqueue_ms"}
    assert wanted <= set(metrics) and not idle & set(metrics)
    k = cell.cfg["k"]
    if name.endswith("serve"):
        assert metrics["serve_h2d_bytes"] == 2 * 4 * cell.mix["batch"]
        assert metrics["serve_engine_self_ms"] > 0 and metrics["serve_upload_ms"] > 0
        assert metrics["serve_gather_enqueue_ms"] > 0
    else:
        n = cell.cfg["network"]["nx"] * cell.cfg["network"]["ny"]
        assert metrics["build_h2d_bytes"] == 2 * (n + 1) * k * 4
        assert metrics["build_extras_ms"] > 0 and metrics["build_sweep_enqueue_ms"] > 0
