"""The port's example twins end to end on the CPU, each in a subprocess with
``--device cpu``, as a user runs them: ``quickstart`` (all thirteen
sections, every equivalence it prints True), ``knn_road_service`` (the
scalar loop, the batched engine and the fleet, at a smaller size than its
default; tables equal a rebuild afterwards) and ``train_lm`` (lm-15m, its
own assertion: the loss falls by at least 0.5)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _run(module: str, *args: str) -> str:
    # one torch thread: the tier-1 run starts several test workers at once
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{module}", *args,
                        "--device", "cpu"], capture_output=True, text=True, env=env,
                       timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return p.stdout


def test_quickstart_twin():
    out = _run("quickstart")
    for section in range(1, 14):
        assert f"== {section}. " in out
    assert "back to original: True" in out
    assert "checks: 10 of 10 hold" in out
    assert "False" not in out.replace("uneven=False", "")


def test_knn_road_service_twin():
    out = _run("knn_road_service", "--grid", "20", "--ops", "600", "--fleet-size", "24",
               "--ticks", "5", "--batch", "128")
    assert "engine tables equal a rebuild on its objects: True" in out
    assert "fleet tables equal a rebuild on its objects: True" in out
    assert "scalar bua_qf" in out and "moving fleet" in out


def test_train_lm_twin():
    out = _run("train_lm", "--steps", "80", "--batch", "8")
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["model"] == "lm-15m" and stats["steps"] == 80
    assert stats["loss"] < stats["first_loss"] - 0.5
