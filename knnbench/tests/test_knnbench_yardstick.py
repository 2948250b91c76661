"""The yardstick: work counts on a hand-sized BN-Graph and a hand-sized
batch, and the reduction of a chrome trace to busy time, kernel time and
idle gaps."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from knnbench import harness
from knnbench.tests.helpers import tiny_cell
from knnbench.yardstick import (F32_OPS_PER_S, HBM_BYTES_PER_S, Trace, least_seconds,
                                serve_batch_bytes, sweep_work)
from repro_torch.core.bngraph import BNGraph


def _hand_bn() -> BNGraph:
    """Four vertices: BNS^< holds 1 + 2 + 0 + 1 = 4 real slots, BNS^> 2 + 1 + 1 + 0."""
    lo = np.array([[2, -1], [0, 3], [-1, -1], [1, -1]], np.int32)
    hi = np.array([[1, 3], [2, -1], [0, -1], [-1, -1]], np.int32)
    w = lambda ids: np.where(ids >= 0, 1.0, np.inf)  # noqa: E731
    return BNGraph(n=4, rank=np.arange(4), order=np.arange(4), lo_ids=lo, lo_w=w(lo),
                   hi_ids=hi, hi_w=w(hi), level_up=np.zeros(4, np.int32),
                   level_down=np.zeros(4, np.int32), rho=2)


def test_sweep_count_on_a_hand_sized_bngraph():
    loop = object.__new__(harness.load_loop("build"))
    loop.bn, loop.k = _hand_bn(), 3
    (least,) = loop.least_s(4, {0}).values()
    # 8 slots (4 + 4), 2 sweeps x 4 rows: 8 B a slot, 4 B a row, 2 x 8 x 3 B a row
    nbytes = 8 * 8 + 4 * 8 + 2 * 8 * 8 * 3
    nops = 2 * (8 * 3 + 8 * 3)
    assert sweep_work(8, 8, 3) == (nbytes, nops)
    assert least == pytest.approx(max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S))
    assert least_seconds(0, F32_OPS_PER_S) == 1.0 and least_seconds(HBM_BYTES_PER_S, 0) == 1.0


def test_serve_batch_bytes_read_each_touched_row_once():
    us = np.array([3, 3, 0, 7, 3], np.int32)          # 3 distinct rows
    k = 4
    assert serve_batch_bytes(us, 10, k) == 8 * 5 + 8 * k * 3 + 8 * k * 5


def _chrome(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction(tmp_path):
    events = [
        _ev("knnbench.traced_window", "user_annotation", 100, 100),
        _ev("knnbench.serve", "user_annotation", 100, 60),
        _ev("aten::copy_", "cpu_op", 105, 30),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 110, 20),
        _ev("(anonymous namespace)::sweep_levels_kernel(int const*, int)", "kernel", 140, 30),
        _ev("void gather_kernel<16, long>(char*, long)", "kernel", 160, 20),  # overlaps
        _ev("knnbench.synchronize", "user_annotation", 160, 40),
        _ev("early kernel(int)", "kernel", 50, 10),                         # outside the window
        _ev("late kernel(int)", "kernel", 190, 30),                          # clipped to 10
    ]
    trace = Trace.from_chrome(_chrome(tmp_path / "t.json", events), "knnbench.traced_window")
    assert trace.window_s == pytest.approx(100e-6)
    # busy: [110, 130) + [140, 180) + [190, 200) = 20 + 40 + 10
    assert trace.busy_s == pytest.approx(70e-6)
    assert trace.kernel_s("sweep_levels_kernel") == pytest.approx(30e-6)
    top = dict(trace.top_ops())
    assert top["(anonymous namespace)::sweep_levels_kernel"] == pytest.approx(30e-6)
    assert top["Memcpy HtoD"] == pytest.approx(20e-6) and "early kernel" not in top
    gaps = dict(trace.idle_gaps())
    # [100, 110) and [130, 140) inside the copy, [180, 190) in the synchronize
    assert gaps["knnbench.serve > aten::copy_"] == pytest.approx(20e-6)
    assert gaps["knnbench.synchronize"] == pytest.approx(10e-6)


def test_trace_without_its_window_reads_nothing(tmp_path):
    path = _chrome(tmp_path / "t.json", [_ev("k(int)", "kernel", 0, 5)])
    assert Trace.from_chrome(path, "knnbench.traced_window") is None


def test_readers_on_a_hand_made_run(tmp_path):
    events = [_ev("knnbench.traced_window", "user_annotation", 0, 1000),
              _ev("(anonymous namespace)::sweep_levels_kernel(int)", "kernel", 0, 400),
              _ev("fill(int)", "kernel", 500, 100)]
    trace = Trace.from_chrome(_chrome(tmp_path / "t.json", events), "knnbench.traced_window")
    ops = [harness.Op(0.0, 0.002, 0.004, 0, 1), harness.Op(0.004, 0.005, 0.008, 1, 1)]
    run = harness.Run("build", ops, ops, trace, {0: 1e-6, 1: 3e-6}, 0.008)
    read = {name: harness.load_reader(name)(run)
            for name in ("build_enqueue_ms", "sweep_merge_levels_roofline", "device_idle_pct.build",
                         "serve_enqueue_ms", "device_idle_pct.serve")}
    assert read["build_enqueue_ms"] == pytest.approx(1.5)
    assert read["sweep_merge_levels_roofline"] == pytest.approx(100 * 4e-6 / 400e-6)
    assert read["device_idle_pct.build"] == pytest.approx(50.0)
    assert read["serve_enqueue_ms"] is None and read["device_idle_pct.serve"] is None


def test_reservoir_keeps_a_seeded_uniform_sample():
    picks = []
    for seed in range(200):
        res = harness.Reservoir(2, np.random.default_rng(seed))
        for i in range(10):
            res.offer(i)
        assert len(res.items) == 2 and len(set(res.items)) == 2
        picks.extend(res.items)
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 20  # every operation of the window can be drawn (mean 40)
    again = harness.Reservoir(2, np.random.default_rng(7))
    for i in range(10):
        again.offer(i)
    first = harness.Reservoir(2, np.random.default_rng(7))
    for i in range(10):
        first.offer(i)
    assert again.items == first.items


def test_serve_count_from_a_tiny_cell():
    cell = tiny_cell("k20-serve")
    loop = harness.load_loop("serve")(cell, None, 196, 5, torch.device("cpu"))
    (least,) = loop.least_s(196, {0}).values()
    assert least == pytest.approx(serve_batch_bytes(loop.us[0], 196, 5) / HBM_BYTES_PER_S)


def test_end_to_end_readers_on_a_hand_made_run():
    # four operations of 2, 2, 3 and 1 requests over a 0.5 s window
    lat = [0.010, 0.020, 0.030, 0.100]
    ops, at = [], 0.0
    for t, items in zip(lat, (2, 2, 3, 1)):
        ops.append(harness.Op(at, at + t / 2, at + t, 0, items))
        at += t
    run = harness.Run("serve", ops, [], None, {}, 0.5)
    assert harness.load_reader("queries_per_s")(run) == pytest.approx(8 / 0.5)
    assert harness.load_reader("query_batch_p95_ms")(run) == pytest.approx(
        float(np.percentile([1e3 * t for t in lat], 95)))
    assert harness.load_reader("index_build_ms")(run) == pytest.approx(1e3 * 0.5 / 4)
    empty = harness.Run("serve", [], [], None, {}, 0.0)
    for name in ("queries_per_s", "query_batch_p95_ms", "index_build_ms"):
        assert harness.load_reader(name)(empty) is None
