"""The slice as a whole, through the ``repro_torch.knn`` facade on the CPU:
build -> query -> flush, checked against the float64 host oracle with
``indices_equivalent`` (atol 1e-9, integer edge weights); and the guards that
keep the port free of the JAX package.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import knn
from repro_torch.configs.knn_index import make_config, make_smoke
from repro_torch.launch import knn_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def test_knn_facade_end_to_end_cpu():
    g = knn.road_network(12, 12, seed=0)
    objects = knn.pick_objects(g.n, 0.1, seed=0)
    bn = knn.build_bngraph(g)
    k = 5
    engine = knn.build_engine(g, objects, k, device="cpu")
    assert engine.device == torch.device("cpu")
    oracle = knn.knn_index_cons_plus(bn, objects, k)
    assert knn.indices_equivalent(oracle, engine.to_index())
    assert knn.indices_equivalent(oracle, knn.build_index(bn, objects, k, device="cpu"))

    us = np.arange(g.n)
    ids, d = engine.query_batch(us)
    assert tuple(ids.shape) == (g.n, k) and bool(torch.isfinite(d[ids >= 0]).all())
    for u in (0, 17, g.n - 1):
        want = oracle.query(u)
        got = [(int(i), float(x)) for i, x in zip(ids[u].tolist(), d[u].tolist()) if i >= 0]
        assert [x for _, x in got] == [x for _, x in want]

    # a flush of mixed moves / inserts / deletes, three times over
    mset = set(objects.tolist())
    rng = np.random.default_rng(5)
    for _ in range(3):
        knn.stage_random_updates(engine, mset, rng, count=10)
        for u in rng.choice(sorted(mset.intersection(engine.objects.tolist())), 3, replace=False):
            v = next(w for w in rng.permutation(g.n).tolist() if w not in mset)
            engine.stage_move(int(u), v)
            mset.discard(int(u))
            mset.add(v)
        res = engine.flush_updates()
        assert res["moves"] >= 1 and res["inserts"] + res["deletes"] >= 1
    final = np.array(sorted(mset))
    np.testing.assert_array_equal(engine.objects, final)
    rebuilt = knn.build_index(bn, final, k, device="cpu")
    assert knn.indices_equivalent(rebuilt, engine.to_index())
    assert knn.indices_equivalent(knn.knn_index_cons_plus(bn, final, k), engine.to_index())
    assert engine.stats()["flushes"] == 3 and engine.epoch == 3


def test_scalar_oracles_roundtrip():
    g = knn.road_network(8, 8, seed=2)
    objects = knn.pick_objects(g.n, 0.2, seed=2)
    bn = knn.build_bngraph(g)
    idx = knn.knn_index_cons_plus(bn, objects, 4)
    start = idx.copy()
    absent = next(v for v in range(g.n) if v not in set(objects.tolist()))
    other = next(v for v in range(g.n) if v not in set(objects.tolist()) and v != absent)
    knn.insert_object(bn, idx, absent)
    knn.move_object(bn, idx, absent, other)
    knn.delete_object(bn, idx, other)
    assert knn.indices_equivalent(start, idx)


def test_facade_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    g = knn.road_network(6, 6, seed=0)
    objects = knn.pick_objects(g.n, 0.3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.build_engine(g, objects, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.build_index(g, objects, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn_build.main(["--grid", "6", "--k", "3"])
    ids = np.full((g.n, 3), -1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn.QueryEngine.from_tables(ids, ids.astype(np.float32), 3, objects)


def test_knn_build_cli_cpu(capsys):
    stats = knn_build.main(["--grid", "10", "--k", "4", "--mu", "0.1", "--device", "cpu", "--verify"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == stats
    assert stats["verified"] is True and stats["n"] == 100 and stats["device"] == "cpu"
    for key in ("m", "|M|", "k", "rho", "tau", "levels_up", "levels_down", "chunks_up",
                "chunks_down", "shape_buckets_up", "shape_buckets_down", "pad_occupancy_up",
                "pad_occupancy_down", "gen_s", "bngraph_s", "sweeps_s", "index_bytes"):
        assert key in stats
    assert stats["index_bytes"] == 100 * 4 * 8


def test_configs_are_the_papers_shapes():
    cfg = make_config()
    assert (cfg.name, cfg.n_vertices, cfg.k, cfg.level_batch, cfg.tau, cfg.query_batch) == (
        "knn-index-usa", 1 << 24, 20, 131072, 32, 1 << 20)
    assert make_smoke().n_vertices == 512


def test_importing_the_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.knn, repro_torch.launch.knn_build, repro_torch.configs.knn_index\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.') or m == 'triton']\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_port_source_mentions_a_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[. ])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 15
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_chip_smoke_has_no_cpu_path():
    """Without a CUDA device the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
