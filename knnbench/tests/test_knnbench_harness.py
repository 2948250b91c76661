"""The harness: finds everything by name, keeps to the benchmark's contract,
refuses to run without a card or without the program, and loads nothing of
JAX or the JAX package."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from knnbench import generator, harness
from knnbench.tests.helpers import run_tiny, tiny_cell

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    assert cell.cfg["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert callable(harness.load_loop(cell.mix["loop"]))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for name in reported - {"setup_s"}:
        assert callable(harness.load_reader(name))
    assert cell.per_layer
    for metric in cell.per_layer:
        assert metric["moves"] in reported
        assert callable(harness.load_reader(metric["name"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["knnbench"] and SPEC["command"][:2] == ["python3", "-m"]
    assert 1 <= SPEC["run_seconds"] <= 51
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for key, keys in allowed.items():
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
        for entry in SPEC[key]:
            assert set(entry) <= keys and NAME.match(entry["name"]), entry
            for text in ("why", "layer") + (("source",) if key == "configs" else ()):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and not set(entry[text]) & {"\n", "\t"}
    for cfg in SPEC["configs"]:
        body = json.loads((ROOT / cfg["file"]).read_text())
        assert cfg["file"].startswith("knnbench/") and body["name"] == cfg["name"]
        assert all(key in body for key in cfg["reduced"])
    for metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and UNIT.match(metric["unit"])
        assert 0.01 <= metric["bound"] <= 0.25 and metric["better"] in ("lower", "higher")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for metric in SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["layer"] in layers
        assert set(metric["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_readers_return_nothing_without_a_trace():
    run = harness.Run("serve", [], [], None, {}, 0.0)
    for metric in SPEC["per_layer"]:
        assert harness.load_reader(metric["name"])(run) is None


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "knnbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "knnbench", tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "knnbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_IMPORTS = """
import sys
sys.path.insert(0, 'src')
{body}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""


def _top_level_after(body: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", _IMPORTS.format(body=body)], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_harness_and_reference_load_no_jax():
    tops = _top_level_after(
        "import knnbench.run, knnbench.harness, knnbench.control, knnbench.reference.judge\n"
        "import knnbench.loops.serve, knnbench.loops.build\n"
        "from knnbench import harness\n"
        "[harness.load_reader(m) for m in ('serve_enqueue_ms', 'serve_gather_roofline',"
        " 'device_idle_pct.serve', 'build_enqueue_ms', 'sweep_merge_levels_roofline',"
        " 'device_idle_pct.build')]")
    assert not tops & set(harness.FORBIDDEN)
    assert "repro_torch" not in tops  # the program is loaded only by a run


def test_reference_loads_nothing_of_the_program():
    tops = _top_level_after("import knnbench.reference.bellman, knnbench.reference.dijkstra,"
                            " knnbench.reference.judge")
    assert "repro_torch" not in tops and not tops & set(harness.FORBIDDEN)


def test_a_run_leaves_no_jax_loaded(tmp_path):
    body = (f"sys.path.insert(0, '.')\n"
            f"from knnbench.tests.helpers import run_tiny, tiny_cell\n"
            f"from knnbench import harness\n"
            f"res, checks = run_tiny(tiny_cell('k20-build'), {str(tmp_path)!r})\n"
            f"assert res['correct'] and not harness.forbidden_modules(), harness.forbidden_modules()")
    tops = _top_level_after(body)
    assert "repro_torch" in tops and not tops & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


@pytest.mark.parametrize("name", ["k20-serve", "k20-build"])
def test_tiny_runs_report_every_metric_of_their_cell(name, tmp_path):
    cell = tiny_cell(name)
    result, checks = run_tiny(cell, tmp_path)
    assert result["correct"] and all(v == 0 for v, _ in checks.values())
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced, _ = run_tiny(cell, tmp_path, trace=True)
    assert traced["correct"]
    # on the CPU the trace holds no device work: the device metrics stay silent
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert f"{cell.mix['loop']}_enqueue_ms" in traced["metrics"]


@pytest.mark.parametrize("dist", [{"dist": "uniform"}, {"dist": "zipf", "s": 1.1}])
def test_vertex_distributions_come_from_the_seed(dist):
    draw = lambda seed: generator.vertices(1000, (4, 500), generator.stream(seed, "v"), dist)  # noqa: E731
    first = draw(2**40 + 1)
    assert first.dtype == np.int32 and first.shape == (4, 500)
    assert first.min() >= 0 and first.max() < 1000
    assert np.array_equal(first, draw(2**40 + 1)) and not np.array_equal(first, draw(2**40 + 2))
    top = np.bincount(first.ravel(), minlength=1000).max() / first.size
    # uniform: about 1/1000 a vertex; zipf at s = 1.1: the first rank draws about 15%
    assert (top > 0.1) == (dist["dist"] == "zipf")


def test_an_unknown_vertex_distribution_is_refused():
    with pytest.raises(ValueError, match="unknown vertex distribution"):
        generator.vertices(10, (2,), generator.stream(1, "v"), {"dist": "normal"})


def test_a_new_mix_is_data_alone(tmp_path):
    # a zipf-skewed serving mix: the serve loop and its readers, no new code
    cell = tiny_cell("k20-serve")
    cell.mix["vertices"] = {"dist": "zipf", "s": 1.1}
    result, checks = run_tiny(cell, tmp_path)
    assert result["correct"] and all(v == 0 for v, _ in checks.values())
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["attempted"] > 0 and result["attempted"] % cell.mix["batch"] == 0
