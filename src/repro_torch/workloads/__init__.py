"""Serving workload generators for the kNN road-network system.

The flagship workload is the moving fleet (``fleet.FleetSim``): vehicles
drive shortest-path trips over the road network and every tick yields a batch
of ``(src, dst)`` moves to stage into the engine, the location-based-service
pattern (ride-hailing, delivery, tracking) where update traffic is dominated
by movement rather than appearance/churn.

Build -> simulate -> query while moving::

    from repro_torch import knn

    g = knn.road_network(40, 40, seed=0)
    sim = knn.FleetSim(g, fleet_size=96, seed=0)
    engine = knn.build_engine(g, sim.positions, k=20)

    for _ in range(100):                      # one serving tick each
        for u, v in sim.tick():               # vehicles advance one street
            engine.stage_move(u, v)           # staged, not yet visible
        ids, dists = engine.query_batch(qs)   # queries see the flushed state
        engine.flush_updates()                # one fused move batch

``python -m repro_torch.launch.serve --arch knn-index --workload fleet`` runs
this loop as a service.
"""
from repro_torch.workloads.fleet import FleetSim, drive_fleet_ticks

__all__ = ["FleetSim", "drive_fleet_ticks"]
