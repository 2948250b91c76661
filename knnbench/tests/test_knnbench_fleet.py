"""The fleet cell (``k20-fleet``): its trace generator, its loop's replay,
a tiny run on the CPU, the readers of the flush's spans and of K3's roofline,
planted faults that must make ``correct`` false, and the control."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from knnbench import flushcost, harness, spec
from knnbench.control import control_readings
from knnbench.data import fleet, road
from knnbench.tests.helpers import run_tiny, tiny_cell
from knnbench.yardstick import Trace
from repro_torch.core import engine as port_engine

SPAN_METRICS = {"flush_updates_ms", "flush_frontier_ms", "flush_repair_ms", "flush_d2h_bytes"}


@pytest.fixture(autouse=True)
def _one_thread_and_a_private_cache(monkeypatch, tmp_path):
    """Many small tensor ops: one intra-op thread keeps them fast under a
    parallel run; the fleet's trace is kept in the test's own directory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(spec, "CACHE", tmp_path)
    yield
    torch.set_num_threads(threads)


def fleet_cell(grid: int = 24, k: int = 5, vehicles: int = 12, ticks: int = 8):
    cell = tiny_cell("k20-fleet", grid=grid, k=k)
    cell.cfg["fleet"].update(vehicles=vehicles, trace_ticks=ticks)
    cell.mix["batch"] = 64
    return cell


def _trace(cfg, seed=None):
    net = harness.make_network(cfg)
    f = cfg["fleet"]
    return net, fleet.generate(net.indptr, net.indices, net.weights, vehicles=f["vehicles"],
                               steps_per_tick=f["steps_per_tick"],
                               seed=f["trace_seed"] if seed is None else seed,
                               ticks=f["trace_ticks"])


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def test_the_trace_is_deterministic_and_keeps_the_fleet_rules():
    cfg = fleet_cell(grid=20, vehicles=40, ticks=30).cfg
    net, first = _trace(cfg)
    _, again = _trace(cfg)
    _, other = _trace(cfg, seed=1)
    for a, b in ((first.start, again.start), (first.moves, again.moves),
                 (first.bounds, again.bounds)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first.moves[:50], other.moves[:50])
    assert first.ticks == 30 and len(np.unique(first.start)) == 40
    edges = set(zip(np.repeat(np.arange(net.n), np.diff(net.indptr)).tolist(),
                    net.indices.tolist()))
    occupied = set(first.start.tolist())
    blocked = 0
    for t in range(first.ticks):
        moved_to = set()
        for u, v in first.tick(t).tolist():
            assert (u, v) in edges                    # one street
            assert u in occupied and v not in occupied  # never two vehicles on a vertex
            assert u not in moved_to                  # one street a tick for each vehicle
            occupied.remove(u)
            occupied.add(v)
            moved_to.add(v)
        blocked += 40 - len(first.tick(t))
    assert len(occupied) == 40 and blocked > 0       # some vehicle waited
    assert [len(s) for s in first.states()] == [40] * 31


def test_every_tick_stages_validly_forward_and_backward():
    cell = fleet_cell(ticks=5)
    loop = harness.load_loop("fleet")(cell, None, 24 * 24, 2**40 + 5, torch.device("cpu"))
    pending = set(loop.states[0].tolist())
    for q in range(2 * loop.cycle):
        for u, v in loop.moves(q % loop.cycle).tolist():
            # QueryEngine.stage_move's rules
            assert u != v and u in pending and v not in pending
            pending.remove(u)
            pending.add(v)
        np.testing.assert_array_equal(sorted(pending), loop.state(q % loop.cycle))
    assert pending == set(loop.states[0].tolist())


def test_the_cache_key_changes_with_each_parameter(tmp_path):
    cfg = fleet_cell().cfg
    base = fleet.cache_path(tmp_path, cfg)
    assert base == fleet.cache_path(tmp_path, cfg)
    changed = []
    for group, key in [("network", k) for k in cfg["network"] if k != "generator"] + [
            ("fleet", k) for k in ("vehicles", "steps_per_tick", "trace_seed", "trace_ticks")]:
        other = {**cfg, group: dict(cfg[group])}
        value = other[group][key]
        other[group][key] = (not value) if isinstance(value, bool) else value + 1
        changed.append(fleet.cache_path(tmp_path, other))
    assert base not in changed and len(set(changed)) == len(changed)


def test_the_trace_is_built_once_and_read_back(tmp_path):
    cfg = fleet_cell().cfg
    logs = []
    built = fleet.load_or_build(cfg, tmp_path, log=logs.append)
    read = fleet.load_or_build(cfg, tmp_path, log=logs.append)
    assert len(logs) == 1 and "fleet_trace_built_s" in logs[0]
    np.testing.assert_array_equal(built.moves, read.moves)
    np.testing.assert_array_equal(built.start, read.start)
    net = road.road_network(**fleet.params(cfg)["network"])
    assert read.start.max() < net.n


# ---------------------------------------------------------------------------
# runs on the CPU
# ---------------------------------------------------------------------------


def test_a_tiny_fleet_run_is_correct_and_reports_every_metric_it_can(tmp_path):
    cell = fleet_cell()
    result, checks = run_tiny(cell, tmp_path, seconds=1.5)
    assert result["correct"] and all(v == 0 for v, _ in checks.values())
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {m["name"] for m in cell.end_to_end} == {"queries_per_s", "query_batch_p95_ms",
                                                   "setup_s"}
    assert result["attempted"] % cell.mix["batch"] == 0 and result["attempted"] > 0
    traced, checks = run_tiny(cell, tmp_path, seconds=3.0, trace=True)
    assert traced["correct"]
    # on the CPU the trace holds no device work: the device metrics stay silent
    assert set(traced["metrics"]) == SPAN_METRICS
    metrics = {m: v["value"] for m, v in traced["metrics"].items()}
    assert 0 < metrics["flush_frontier_ms"] + metrics["flush_repair_ms"] \
        < metrics["flush_updates_ms"]
    assert 0 < metrics["flush_d2h_bytes"] < 64 * 1024
    assert {m["name"] for m in cell.per_layer} >= SPAN_METRICS | {
        "device_idle_pct.fleet", "flush_idle_in_frontier_ms", "frontier_relax_roofline"}


def _lost_move(monkeypatch):
    """The first flush drops its last staged move from the tables, while
    the engine's object set records it."""
    real, done = port_engine.EngineCore.flush_updates, []

    def lossy(self):
        moves = [op for op in self._staged if op[0] == "mov"]
        if done or not moves:
            return real(self)
        done.append(moves[-1])
        _, u, v = moves[-1]
        self._staged.remove(moves[-1])
        self._pending.add(u)
        self._pending.discard(v)
        out = real(self)
        for s in (self._objects, self._pending):
            s.discard(u)
            s.add(v)
        return out
    monkeypatch.setattr(port_engine.EngineCore, "flush_updates", lossy)


def _batch_before_flush(monkeypatch):
    """Each batch reads the epoch before the tick's flush."""
    real = port_engine.EngineCore.query_batch

    def stale(self, us, k=None, *, epoch=None):
        prev = self.epoch - 1
        return real(self, us, k, epoch=prev if prev in self.retained_epochs() else epoch)
    monkeypatch.setattr(port_engine.EngineCore, "query_batch", stale)


@pytest.mark.parametrize("plant", [_lost_move, _batch_before_flush],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_a_planted_fault_makes_the_fleet_run_incorrect(plant, monkeypatch, tmp_path):
    cell = fleet_cell()
    intact, checks = run_tiny(cell, tmp_path, seconds=1.0)
    assert intact["correct"] and all(v == 0 for v, _ in checks.values())
    plant(monkeypatch)
    broken, checks = run_tiny(cell, tmp_path, seconds=1.0)
    assert not broken["correct"]
    assert checks["wrong_answers"][0] > 0


def test_the_control_fails_and_the_exact_reference_is_the_program(tmp_path):
    # 48 x 48 with 8 vehicles at k = 8: the farther rows' distances pass 256,
    # where bfloat16's 8 significant bits round; the control fails by a limit
    cell = fleet_cell(grid=48, k=8, vehicles=8, ticks=6)
    low = control_readings(cell, 2**35 + 1, torch.device("cpu"), bits=8, exact=True,
                           cache_dir=tmp_path)
    assert low["exact_equal"]
    assert any(low[key] > 0 for key in low["limits"])
    full = control_readings(cell, 2**35 + 1, torch.device("cpu"), bits=24)
    assert all(full[key] == 0 for key in full["limits"])


# ---------------------------------------------------------------------------
# readers on hand-made traces
# ---------------------------------------------------------------------------

US = 1e-6


def _fleet_run(least_s=None, traced=2):
    """Two ticks (times in microseconds): flush [0, 60) with its frontier
    [5, 40) and repair [45, 58), the device busy in [10, 20) (K3) and
    [46, 50); the second tick the same shifted by 100."""
    host, device = [], []
    for t0 in (0, 100)[:traced]:
        host += [("knnbench.fleet", t0, t0 + 90), (flushcost.FLUSH, t0, t0 + 60),
                 (flushcost.FRONTIER, t0 + 5, t0 + 40), (flushcost.REPAIR, t0 + 45, t0 + 58)]
        device += [("void frontier_relax_kernel<4, false>(int)", t0 + 10, t0 + 20),
                   ("sweep_merge_kernel", t0 + 46, t0 + 50)]
    trace = Trace(0.0, 200 * US, [(n, s * US, e * US) for n, s, e in device],
                  [(n, s * US, e * US) for n, s, e in host])
    ops = [harness.Op(0.0, 0.0, 0.0, j, 64) for j in range(traced)]
    return harness.Run("fleet", ops, ops, trace, {} if least_s is None else least_s, 1.0)


def _read(name, run):
    return harness.load_reader(name)(run)


def test_flush_readers_on_a_hand_made_trace():
    run = _fleet_run()
    ms = 1e-3
    assert _read("flush_updates_ms", run) == pytest.approx(60 * ms)
    assert _read("flush_frontier_ms", run) == pytest.approx(35 * ms)
    assert _read("flush_repair_ms", run) == pytest.approx(13 * ms)
    # the frontier [5, 40) less K3's [10, 20)
    assert _read("flush_idle_in_frontier_ms", run) == pytest.approx(25 * ms)
    assert _read("device_idle_pct.fleet", run) == pytest.approx(100 * (1 - 28 / 200))
    # without the counter the roofline reads nothing; with it, least over K3's time
    assert _read("frontier_relax_roofline", run) is None
    run = _fleet_run({0: 4 * US, 1: 6 * US})
    assert _read("frontier_relax_roofline", run) == pytest.approx(100 * 10 / 20)
    assert _read("frontier_relax_roofline", _fleet_run({0: 4 * US})) is None


def test_flush_readers_read_nothing_on_another_loop():
    run = _fleet_run({0: 1e-6, 1: 1e-6})
    other = harness.Run("serve", run.ops, run.traced_ops, run.trace, run.least_s, 1.0)
    for name in SPAN_METRICS | {"flush_idle_in_frontier_ms", "device_idle_pct.fleet",
                                "frontier_relax_roofline"}:
        assert _read(name, other) is None


def test_k3_bytes_follow_the_benchmark_rule():
    cell = fleet_cell(grid=16, vehicles=10, ticks=2)
    net = harness.make_network(cell.cfg)
    from repro_torch.core.bngraph import build_bngraph
    from repro_torch.graph.csr import from_edges
    from repro_torch import trace as port_trace

    bn = build_bngraph(from_edges(net.n, net.edges()))
    loop = harness.load_loop("fleet")(cell, bn, net.n, 2**33 + 1, torch.device("cpu"))
    eng, parts = loop.engine, []
    real = port_engine.QueryEngine._frontier_part

    def part(self, state, rows):
        parts.append(np.array(rows))
        return real(self, state, rows)
    port_engine.QueryEngine._frontier_part = part
    try:
        loop.op(0)
    finally:
        port_engine.QueryEngine._frontier_part = real
    counted = port_trace.last(flushcost.FLUSH)["k3_bytes"]
    # a source column for each vertex the tick's flush gained an object on
    b = len(set(loop.state(0).tolist()) - set(loop.states[0].tolist()))
    want = 0
    for p in parts:
        deg = eng._nbr_deg[p]
        nbrs = np.unique(np.concatenate([eng._nbr_ids[v, :d] for v, d in zip(p, deg)]))
        want += flushcost.k3_least_bytes(int(deg.sum()), len(nbrs), len(p), b)
    assert counted == want > 0
