"""The port's moving-fleet workload and serving driver (on the CPU), held
against the JAX package.

``FleetSim`` is the JAX package's simulator, copied: the same seed must give
the same positions and the same moves, tick for tick. A fleet trace staged
into the port's engine and into the JAX engine must leave equal tables after
every tick (exact: ``array_equal`` on int32 ids and float32 distances). The
command-line entry points run end to end in process with ``--device cpu``.
"""
import json

import numpy as np
import pytest
import torch

from repro import knn as jknn
from repro.workloads.fleet import FleetSim as JaxFleetSim
from repro.workloads.fleet import shortest_path as jax_shortest_path
from repro_torch import knn
from repro_torch.launch import knn_build, serve
from repro_torch.workloads import drive_fleet_ticks
from repro_torch.workloads.fleet import shortest_path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_ticks_match_jax(seed):
    g, jg = knn.road_network(10, 12, seed=seed), jknn.road_network(10, 12, seed=seed)
    sim = knn.FleetSim(g, fleet_size=25, seed=seed)
    jsim = JaxFleetSim(jg, fleet_size=25, seed=seed)
    np.testing.assert_array_equal(sim.positions, jsim.positions)
    for _ in range(8):
        assert sim.tick() == jsim.tick()
        np.testing.assert_array_equal(sim.positions, jsim.positions)
    assert sim.stats() == jsim.stats()
    assert sim.stats()["moves_total"] > 0


def test_shortest_path_matches_jax():
    g, jg = knn.road_network(9, 9, seed=4), jknn.road_network(9, 9, seed=4)
    rng = np.random.default_rng(4)
    for s, t in rng.integers(0, g.n, size=(12, 2)).tolist():
        assert shortest_path(g, s, t) == jax_shortest_path(jg, s, t)


def test_fleet_size_validation():
    g = knn.road_network(4, 4, seed=0)
    for size in (g.n, 0, -1):
        with pytest.raises(ValueError):
            knn.FleetSim(g, fleet_size=size, seed=0)


def test_fleet_trace_through_engine_matches_jax_after_every_tick():
    g, jg = knn.road_network(10, 10, seed=3), jknn.road_network(10, 10, seed=3)
    bn, jbn = knn.build_bngraph(g), jknn.build_bngraph(jg)
    k = 4
    sim = knn.FleetSim(g, fleet_size=24, seed=3)
    engine = knn.build_engine(bn, sim.positions, k, device="cpu")
    jengine = jknn.build_engine(jbn, sim.positions, k)
    for _ in range(6):
        for u, v in sim.tick():
            engine.stage_move(u, v)
            jengine.stage_move(u, v)
        assert engine.flush_updates() == jengine.flush_updates()
        for mine, theirs in zip(engine._host_tables(), jengine._host_tables()):
            np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(engine.objects, sim.positions)
    fresh = knn.knn_index_cons_plus(bn, sim.positions, k)
    assert knn.indices_equivalent(fresh, engine.to_index())
    assert engine.stats()["moves_applied"] > 0


def test_drive_fleet_ticks_stages_queries_and_flushes():
    g = knn.road_network(10, 10, seed=5)
    bn = knn.build_bngraph(g)
    sim = knn.FleetSim(g, fleet_size=20, seed=5)
    engine = knn.build_engine(bn, sim.positions, 4, device="cpu")
    r = drive_fleet_ticks(engine, (sim.tick() for _ in range(4)), batch=32,
                          rng=np.random.default_rng(0))
    assert r["ticks"] == 4 and len(r["lat"]) == 4 and r["moves"] == sim.moves_total
    assert engine.epoch == 4 and engine.stats()["queries_served"] == 4 * 32
    np.testing.assert_array_equal(engine.objects, sim.positions)


def test_knn_build_out_then_serve_artifact(tmp_path, capsys):
    art = str(tmp_path / "index.npz")
    built = knn_build.main(["--grid", "10", "--k", "4", "--mu", "0.2", "--device", "cpu",
                            "--verify", "--out", art])
    assert json.loads(capsys.readouterr().out) == built
    assert built["verified"] is True
    assert built["bngraph_certificate"] == {
        "relaxation_stable": True, "rank_consistent": True, "ok": True}
    assert built["index_bytes"] == built["n"] * built["k"] * 8

    out = serve.main(["--arch", "knn-index", "--smoke", "--grid", "10", "--k", "4", "--mu", "0.2",
                      "--ops", "600", "--batch", "128", "--update-frac", "0.05",
                      "--artifact", art, "--device", "cpu", "--inject-flush-failure", "2"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["arch"] == "knn-index" and out["device"] == "cpu"
    assert out["queries"] > 0 and out["queries_per_s"] > 0 and out["updates"] > 0
    assert out["errors"] == 1 and "injected flush failure" in out["last_error"]
    assert out["engine"]["staged_queue_depth"] == 0  # the failed batch was retried
    assert out["engine"]["flushes"] == out["rounds"] - 1
    assert out["engine"]["flushes_failed"] == 1
    # the scalar engine reports the sharded keys unset, as the JAX serve.py does
    assert {key: out[key] for key in ("partition", "replicate", "replicated_shard", "hot_frac",
                                      "repartition_rounds", "repartitioned_at_round")} == {
        "partition": None, "replicate": None, "replicated_shard": None, "hot_frac": 0.0,
        "repartition_rounds": [], "repartitioned_at_round": None}


def test_serve_loads_a_jax_written_artifact(tmp_path, capsys):
    jg = jknn.road_network(9, 9, seed=0)
    jeng = jknn.build_engine(jknn.build_bngraph(jg), jknn.pick_objects(jg.n, 0.2, seed=0), 4)
    art = str(tmp_path / "jax.npz")
    jeng.save(art)
    out = serve.main(["--smoke", "--grid", "9", "--k", "4", "--ops", "300", "--batch", "64",
                      "--artifact", art, "--device", "cpu"])
    capsys.readouterr()
    assert out["errors"] == 0 and out["updates"] > 0 and out["engine"]["flushes"] > 0


def test_serve_fleet_workload(capsys):
    out = serve.main(["--smoke", "--grid", "10", "--k", "4", "--workload", "fleet",
                      "--fleet-size", "12", "--ticks", "5", "--batch", "64", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["workload"] == "fleet" and out["ticks"] == 5
    assert out["engine"]["flushes"] == 5 and out["sim"]["moves_total"] > 0
    assert out["engine"]["num_objects"] == 12
    assert out["query_p50_us"] > 0 and out["ticks_per_s"] > 0


def test_serve_query_batch_is_an_alias_of_batch(capsys):
    """``--query-batch`` sets the knn query batch, as in the JAX package's serve.py."""
    common = ["--arch", "knn-index", "--grid", "10", "--k", "4", "--device", "cpu",
              "--ops", "200"]
    alias = serve.main(common + ["--query-batch", "64"])
    assert json.loads(capsys.readouterr().out) == alias
    plain = serve.main(common + ["--batch", "64"])
    capsys.readouterr()
    assert alias.keys() == plain.keys() and alias["engine"].keys() == plain["engine"].keys()
    assert alias["batch"] == 64 and alias["errors"] == 0
    timed = ("_s", "_per_s", "us_per_query")
    for out in (alias, plain):
        for key in [key for key in out if key.endswith(timed)]:
            del out[key]
        for key in [key for key in out["engine"] if key.startswith("t_")]:
            del out["engine"][key]
    assert alias == plain


def test_serve_rejects_what_it_cannot_serve(tmp_path):
    with pytest.raises(SystemExit, match="arch family.*'gnn'.*launch.train"):
        serve.main(["--arch", "gcn-cora"])
    with pytest.raises(SystemExit, match="cannot be combined"):
        serve.main(["--smoke", "--grid", "6", "--workload", "fleet", "--artifact", "x.npz",
                    "--device", "cpu"])
    art = str(tmp_path / "small.npz")
    g = knn.road_network(6, 6, seed=0)
    knn.build_engine(g, knn.pick_objects(g.n, 0.3, seed=0), 3, device="cpu").save(art)
    with pytest.raises(SystemExit, match="does not match"):
        serve.main(["--smoke", "--grid", "6", "--k", "4", "--artifact", art, "--device", "cpu"])


def test_serve_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--grid", "6"])
