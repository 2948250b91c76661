"""The port's fleet workload knobs held against the JAX package's:
``FleetSim(steps_per_tick=)`` and ``drive_fleet_ticks(split=)``.

Tolerance: exact. The same seed and ``steps_per_tick`` give the same positions
and moves tick for tick, and the same tick trace driven fused or split through
the port's engine and the JAX engine leaves ``array_equal`` tables (int32 ids,
float32 distances) and equal engine stats.
"""
import numpy as np
import pytest
import torch

from repro import knn as jknn
from repro.workloads import drive_fleet_ticks as jax_drive
from repro.workloads.fleet import FleetSim as JaxFleetSim
from repro_torch import knn
from repro_torch.workloads import drive_fleet_ticks

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs many small tensor ops; under a parallel test
    run (several workers on a few cores) torch's intra-op thread pool makes
    each one wait on oversubscribed threads, 30x slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STATS = ("flushes", "inserts_applied", "deletes_applied", "moves_applied", "coalesced",
         "rows_repaired", "repair_rounds_last", "frontier_rounds_last", "queries_served",
         "query_batches", "epoch", "num_objects")


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_steps_per_tick_matches_jax(steps):
    g, jg = knn.road_network(10, 12, seed=steps), jknn.road_network(10, 12, seed=steps)
    sim = knn.FleetSim(g, fleet_size=25, seed=steps, steps_per_tick=steps)
    jsim = JaxFleetSim(jg, fleet_size=25, seed=steps, steps_per_tick=steps)
    assert sim.steps_per_tick == jsim.steps_per_tick == steps
    for _ in range(6):
        assert sim.tick() == jsim.tick()
        np.testing.assert_array_equal(sim.positions, jsim.positions)
    assert sim.stats() == jsim.stats()


@pytest.mark.parametrize("steps", [0, -1])
def test_steps_per_tick_below_one_raises_as_in_jax(steps):
    g = knn.road_network(4, 4, seed=0)
    with pytest.raises(ValueError, match="steps_per_tick must be >= 1"):
        knn.FleetSim(g, fleet_size=3, seed=0, steps_per_tick=steps)
    with pytest.raises(ValueError, match="steps_per_tick must be >= 1"):
        JaxFleetSim(jknn.road_network(4, 4, seed=0), fleet_size=3, seed=0, steps_per_tick=steps)


@pytest.mark.parametrize("steps,split", [(1, False), (1, True), (3, False)])
def test_drive_fleet_ticks_matches_jax(steps, split):
    g = knn.road_network(10, 10, seed=6)
    bn, jbn = knn.build_bngraph(g), jknn.build_bngraph(jknn.road_network(10, 10, seed=6))
    sim = knn.FleetSim(g, fleet_size=22, seed=6, steps_per_tick=steps)
    init = sim.positions.copy()
    trace = [sim.tick() for _ in range(5)]
    engine = knn.build_engine(bn, init, 4, device="cpu")
    jengine = jknn.build_engine(jbn, init, 4)
    r = drive_fleet_ticks(engine, trace, batch=16, rng=np.random.default_rng(1), split=split)
    jr = jax_drive(jengine, trace, batch=16, rng=np.random.default_rng(1), split=split)
    assert (r["ticks"], r["moves"]) == (jr["ticks"], jr["moves"]) == (5, sim.moves_total)
    assert len(r["lat"]) == 5
    for mine, theirs in zip(engine._host_tables(), jengine._host_tables()):
        np.testing.assert_array_equal(mine, theirs)
    ts, js = engine.stats(), jengine.stats()
    assert {key: ts[key] for key in STATS} == {key: js[key] for key in STATS}
    assert ts["flushes"] == (10 if split else 5)
    assert (ts["moves_applied"] > 0) != split  # split stages no move
    np.testing.assert_array_equal(engine.objects, sim.positions)
