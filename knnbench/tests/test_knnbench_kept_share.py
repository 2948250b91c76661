"""The reader of K2's tally (``knnbench/metrics/sweep_kept_share.py``): the
share of the gathered candidates that the kernel kept, from the program's
``k2_gathered`` and ``k2_kept`` counters of its last build, and nothing
where the program keeps no such counters: on the other loop, without the
counters' module, and on the plain path, which counts nothing."""
from __future__ import annotations

import sys

import pytest

from knnbench import harness, spans
from knnbench.tests.helpers import run_tiny, tiny_cell
from knnbench.yardstick import Trace

US = 1e-6


def _read(run):
    return harness.load_reader("sweep_kept_share")(run)


def _build_trace() -> Trace:
    """One build: build_knn_tables [0, 90) with the sweeps' enqueue in it;
    the device sweeps in [32, 88)."""
    host = [("knnbench.build", 0, 95), (spans.BUILD, 0, 90), (spans.SWEEPS[0], 31, 33),
            (spans.SWEEPS[1], 33, 34)]
    device = [("sweep_levels_kernel(int)", 32, 88)]
    return Trace(0.0, 100 * US, [(n, s * US, e * US) for n, s, e in device],
                 [(n, s * US, e * US) for n, s, e in host])


def _serve_trace() -> Trace:
    host = [("knnbench.serve", 0, 40), (spans.QUERY_BATCH, 1, 39)]
    device = [("gather(long)", 18, 30)]
    return Trace(0.0, 100 * US, [(n, s * US, e * US) for n, s, e in device],
                 [(n, s * US, e * US) for n, s, e in host])


def _run(kind, trace):
    ops = [harness.Op(0.0, 0.0, 0.0, 0, 1)]
    return harness.Run(kind, ops, ops, trace, {}, 1.0)


def _build(tallies):
    """One build span that counts ``tallies`` (gathered, kept) as device
    words, one pair a sweep, as the kernel's path hands them on."""
    import torch

    from repro_torch import trace

    with trace.span(spans.BUILD):
        trace.count("h2d_bytes", 40)
        for gathered, kept in tallies:
            trace.count("k2_gathered", torch.tensor(gathered, dtype=torch.int64))
            trace.count("k2_kept", torch.tensor(kept, dtype=torch.int64))


@pytest.mark.parametrize("tallies, share", [
    (((300, 90), (500, 110)), 100 * 200 / 800),   # two sweeps: summed, then divided
    (((7, 7),), 100.0),                           # nothing above any bound
    (((1024, 0), (0, 0)), 0.0),                   # every candidate dropped
])
def test_the_kept_share_reads_the_last_builds_kernel_tally(tallies, share):
    build = _run("build", _build_trace())
    _build(tallies)
    assert _read(build) == pytest.approx(share)
    _build(((5, 1),))  # a later build: its own tally, not the sum of both
    assert _read(build) == pytest.approx(20.0)


def test_the_kept_share_reads_nothing_without_the_kernels_tally(monkeypatch):
    from repro_torch import trace

    build = _run("build", _build_trace())
    with trace.span(spans.BUILD):  # a build on the plain path: no tally
        trace.count("h2d_bytes", 40)
    assert _read(build) is None
    _build(((0, 0),))  # nothing gathered: no share
    assert _read(build) is None
    _build(((300, 90),))
    assert _read(_run("serve", _serve_trace())) is None       # the other loop
    assert _read(harness.Run("build", [], [], None, {}, 1.0)) is None  # untraced
    # a program without the counters' module
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert _read(build) is None


def test_a_tiny_traced_build_on_the_plain_path_leaves_the_kept_share_out(tmp_path):
    cell = tiny_cell("k20-build")
    assert "sweep_kept_share" in {m["name"] for m in cell.per_layer}
    # a window long enough that operations run after the trace's start at a
    # quarter of it, however loaded the host
    result, _ = run_tiny(cell, tmp_path, trace=True, seconds=3.0)
    assert result["correct"]
    metrics = {m: v["value"] for m, v in result["metrics"].items()}
    # the build's own counter reads, K2's tally does not: only the kernel keeps it
    assert metrics["build_h2d_bytes"] > 0
    assert "sweep_kept_share" not in metrics
