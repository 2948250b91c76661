"""The port's program spans and counters (``repro_torch.trace``): the spans
of the serving and construction paths as a ``torch.profiler`` session
records them, their nesting, the gate that keeps them off the profiler when
none runs, and the bytes counted at each host -> device crossing."""
import ast
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import knn, trace
from repro_torch.analysis.replint import run as replint_run
from repro_torch.core import construct
from repro_torch.core.bngraph import build_bngraph
from repro_torch.graph.generators import pick_objects, road_network

K = 4


@pytest.fixture(scope="module")
def bn():
    return build_bngraph(road_network(8, 8, seed=3))


@pytest.fixture(scope="module")
def objects(bn):
    return pick_objects(bn.n, 0.1, seed=5)


@pytest.fixture(scope="module")
def engine(bn, objects):
    return knn.build_engine(bn, objects, K, device="cpu")


def _annotations(prof, tmp_path) -> list[tuple[str, float, float]]:
    """The ``repro_torch.*`` user annotations of an exported chrome trace,
    as (name, start, end) in trace microseconds, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("repro_torch.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_query_batch_spans_nest_in_the_chrome_trace(engine, tmp_path):
    us = np.arange(engine.n, dtype=np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.query_batch(us)
    spans = _annotations(prof, tmp_path)
    (qb,) = _named(spans, "repro_torch.query_batch")
    (gb,) = _named(spans, "repro_torch.gather_batch")
    ups = _named(spans, "repro_torch.upload")
    assert {s[0] for s in spans} == {"repro_torch.query_batch", "repro_torch.gather_batch",
                                     "repro_torch.upload"}
    assert _inside(gb, qb) and len(ups) == 2 and all(_inside(u, gb) for u in ups)


def test_sharded_query_batch_carries_the_same_spans(bn, objects, tmp_path):
    eng = knn.build_sharded_engine(bn, objects, K, shards=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.query_batch(np.arange(eng.n, dtype=np.int32))
    spans = _annotations(prof, tmp_path)
    (qb,) = _named(spans, "repro_torch.query_batch")
    (gb,) = _named(spans, "repro_torch.gather_batch")
    assert _inside(gb, qb)
    assert all(_inside(u, gb) for u in _named(spans, "repro_torch.upload"))


def test_build_spans_nest_in_the_chrome_trace(bn, objects, tmp_path):
    plans = (construct.prepare_sweep(bn, "up", device="cpu"),
             construct.prepare_sweep(bn, "down", device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        construct.build_knn_tables(bn, objects, K, device="cpu", plans=plans)
    spans = _annotations(prof, tmp_path)
    (build,) = _named(spans, "repro_torch.build_knn_tables")
    (extras,) = _named(spans, "repro_torch.object_extras")
    (up,) = _named(spans, "repro_torch.run_sweep.up")
    (down,) = _named(spans, "repro_torch.run_sweep.down")
    ups = _named(spans, "repro_torch.upload")
    assert all(_inside(s, build) for s in (extras, up, down))
    assert extras[2] <= up[1] and up[2] <= down[1]
    assert len(ups) == 2 and all(_inside(u, extras) for u in ups)
    assert len(spans) == 6


def test_spans_stay_off_the_profiler_when_none_runs(engine, bn, objects, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("repro_torch.test"):
        trace.count("h2d_bytes", 3)
    engine.query_batch(np.arange(8, dtype=np.int32))
    construct.build_knn_tables(bn, objects, K, device="cpu")
    assert trace.last("repro_torch.test") == {"h2d_bytes": 3}


def test_the_gate_flag_flips_inside_a_profiler_session():
    # the gate reads this flag: a torch that stopped setting it would drop every span
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("k", [None, 2, "per-query"])
def test_a_batch_counts_the_bytes_it_uploads(engine, k):
    us = np.arange(engine.n, dtype=np.int32)[::-1].copy()
    ks = np.full(us.shape, K if k is None else 2, np.int32)
    if k == "per-query":
        k = ks = (np.arange(engine.n) % K + 1).astype(np.int32)
    engine.query_batch(us, k)
    assert trace.last("repro_torch.query_batch")["h2d_bytes"] == us.nbytes + ks.nbytes
    engine.query_batch(us[:5], None if k is None else 2)
    assert trace.last("repro_torch.query_batch")["h2d_bytes"] == 2 * 5 * 4


def test_a_build_counts_its_two_extras_tables(bn, objects):
    construct.build_knn_tables(bn, objects, K, device="cpu")
    # K2's tally is the kernel's: the plain version counts no candidates
    assert trace.last("repro_torch.build_knn_tables") == {"h2d_bytes": 2 * (bn.n + 1) * K * 4}


def _refuse_reads(*args, **kwargs):
    raise AssertionError("a tensor counter was read before trace.last")


def test_a_tensor_counter_stays_a_tensor_until_last(monkeypatch):
    with monkeypatch.context() as m:
        for name in ("__int__", "__index__", "__float__", "__bool__", "item", "tolist", "cpu",
                     "numpy"):
            m.setattr(torch.Tensor, name, _refuse_reads)
        with trace.span("repro_torch.outer"):
            trace.count("k2_gathered", torch.tensor(300, dtype=torch.int64))
            with trace.span("repro_torch.inner"):
                trace.count("k2_gathered", torch.tensor(500, dtype=torch.int64))
                trace.count("k2_kept", torch.tensor(90, dtype=torch.int64))
            trace.count("h2d_bytes", 3)
            trace.count("h2d_bytes", np.int64(4))  # ints count as before
            held = dict(trace._counts)
    assert isinstance(held["k2_gathered"], torch.Tensor)
    assert isinstance(held["k2_kept"], torch.Tensor) and held["h2d_bytes"] == 7
    got = trace.last("repro_torch.outer")
    assert got == {"k2_gathered": 800, "k2_kept": 90, "h2d_bytes": 7}
    assert all(type(v) is int for v in got.values())


def test_counts_go_to_the_outermost_open_span():
    trace.count("h2d_bytes", 99)                    # no span open: dropped
    with trace.span("repro_torch.outer"):
        trace.count("h2d_bytes", 1)
        with trace.span("repro_torch.inner"):
            trace.count("h2d_bytes", 2)
            trace.count("other", 5)
    assert trace.last("repro_torch.outer") == {"h2d_bytes": 3, "other": 5}
    assert trace.last("repro_torch.inner") == {}
    assert trace.last("repro_torch.never") == {}
    with pytest.raises(ValueError):                 # a call that raised is not the last
        with trace.span("repro_torch.outer"):
            trace.count("h2d_bytes", 7)
            raise ValueError
    assert trace.last("repro_torch.outer") == {"h2d_bytes": 3, "other": 5}
    with trace.span("repro_torch.after"):           # and leaves no span open behind it
        pass
    assert trace.last("repro_torch.after") == {}


def test_the_module_is_lint_clean_and_free_of_jax():
    source = open(trace.__file__).read()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[. ])",
                         source, re.M)
    # no call in it can wait for the device but ``last``'s int() of a device
    # counter, after the window
    called = {node.func.attr for node in ast.walk(ast.parse(source))
              if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}
    assert not called & {"synchronize", "item", "cpu", "numpy", "tolist", "to", "cuda"}
    assert replint_run([trace.__file__]) == []
