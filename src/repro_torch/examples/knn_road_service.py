"""Location-based-service scenario (paper Figure 1 / Exp-9): a running kNN
service over a road network with mixed query + object-update traffic. The
port's twin of the JAX package's ``examples/knn_road_service.py``.

    PYTHONPATH=src python -m repro_torch.examples.knn_road_service [--grid 40] [--k 20]

Simulates a Yelp/Uber-style workload: 95% kNN queries ("nearest coffee"),
5% object updates (stores opening/closing). Two serving paths over the SAME
traffic:

  scalar host loop — one ``KNNIndex.query`` / ``insert_object`` /
      ``delete_object`` Python call per op (the paper's per-request model,
      kept as the baseline);
  batched QueryEngine — queries served in ``query_batch`` tiles, updates
      staged into the engine queue and flushed once per tile (the BUA
      arrival model), the tables on the device via ``repro_torch.knn``.

Then switches the update traffic to the *moving-fleet* workload: a
``knn.FleetSim`` drives the fleet along shortest-path trips, every tick's
(src, dst) moves are staged via ``stage_move`` and flushed as one fused
batch between query tiles.

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain versions of the kernels. Prints the throughputs and speedups; the
engine paths are also what ``repro_torch.launch.serve --arch knn-index
[--workload fleet]`` runs as a service.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import knn
from repro_torch.device import resolve_device, synchronize
from repro_torch.workloads import drive_fleet_ticks


def run_scalar_loop(bn, idx, objects, n_ops: int, update_frac: float, k: int,
                    mode: str, seed: int = 0) -> float:
    """Baseline: per-op Python dispatch (one row scan / heap loop per call)."""
    rng = np.random.default_rng(seed)
    mset = set(objects.tolist())
    ops_done = 0
    queries = rng.integers(0, bn.n, size=n_ops)
    is_update = rng.random(n_ops) < update_frac
    t0 = time.perf_counter()
    if mode == "bua_qf":  # queries first, then the update batch
        order = np.argsort(is_update, kind="stable")
    else:  # rua_fcfs: arrival order
        order = np.arange(n_ops)
    for i in order:
        if is_update[i]:
            v = int(queries[i])
            if v in mset and len(mset) > k + 1:
                knn.delete_object(bn, idx, v)
                mset.discard(v)
            elif v not in mset:
                knn.insert_object(bn, idx, v)
                mset.add(v)
        else:
            idx.query(int(queries[i]))
        ops_done += 1
    return ops_done / (time.perf_counter() - t0)


def run_engine_batched(engine, n_ops: int, update_frac: float,
                       batch: int, seed: int = 0) -> dict:
    """Engine path: query tiles + staged updates flushed per tile (BUA+QF)."""
    rng = np.random.default_rng(seed)
    mset = set(engine.objects.tolist())
    n_upd = int(round(batch * update_frac))
    n_q = batch - n_upd

    def one_tile():
        us = rng.integers(0, engine.n, size=n_q)
        engine.query_batch(us)
        synchronize(engine.device)
        if knn.stage_random_updates(engine, mset, rng, n_upd):
            engine.flush_updates()

    one_tile()  # warm: kernel build and load, allocator, untimed
    ops_done = queries = updates = 0
    t_q = t_u = 0.0
    while ops_done < n_ops:
        t0 = time.perf_counter()
        engine.query_batch(rng.integers(0, engine.n, size=n_q))
        synchronize(engine.device)
        t_q += time.perf_counter() - t0
        queries += n_q
        t0 = time.perf_counter()
        staged = knn.stage_random_updates(engine, mset, rng, n_upd)
        if staged:
            engine.flush_updates()
        t_u += time.perf_counter() - t0
        updates += staged
        ops_done += n_q + staged
    return {
        "ops_per_s": ops_done / max(t_q + t_u, 1e-9),
        "queries_per_s": queries / max(t_q, 1e-9),
        "updates_per_s": updates / max(t_u, 1e-9) if updates else 0.0,
    }


def run_fleet(g, bn, k: int, fleet_size: int, ticks: int, batch: int, device,
              seed: int = 0) -> dict:
    """Moving-fleet path: per tick, stage the tick's moves + serve a tile."""
    sim = knn.FleetSim(g, fleet_size=fleet_size, seed=seed)
    engine = knn.build_engine(bn, sim.positions, k, device=device)
    rng = np.random.default_rng(seed)
    engine.query_batch(rng.integers(0, g.n, size=batch))
    synchronize(engine.device)
    r = drive_fleet_ticks(engine, (sim.tick() for _ in range(ticks)), batch=batch, rng=rng)
    return {
        "ticks_per_s": ticks / r["wall_s"],
        "moves_per_tick": sim.moves_total / ticks,
        "query_p50_us": float(np.percentile(r["lat"], 50)) * 1e6,
        "query_p99_us": float(np.percentile(r["lat"], 99)) * 1e6,
        "engine": engine,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=40)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--mu", type=float, default=0.02)
    ap.add_argument("--ops", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--update-frac", type=float, default=0.05)
    ap.add_argument("--fleet-size", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = knn.road_network(args.grid, args.grid, seed=0)
    objects = knn.pick_objects(g.n, args.mu, seed=0)
    print(f"network: n={g.n} m={g.m}; |M|={len(objects)}; k={args.k}; device={device}")
    t0 = time.perf_counter()
    bn = knn.build_bngraph(g)
    engine = knn.QueryEngine.build(bn, objects, args.k, device=device)
    idx = engine.to_index()
    print(f"index built in {time.perf_counter() - t0:.2f}s "
          f"({idx.size_bytes(dist_bytes=4) / 1024:.0f} KiB on device)")

    base = {}
    for mode in ("bua_qf", "rua_fcfs"):
        thr = run_scalar_loop(bn, idx.copy(), objects, args.ops, args.update_frac,
                              args.k, mode)
        base[mode] = thr
        print(f"scalar {mode:10s}: {thr:,.0f} ops/s "
              f"({1 - args.update_frac:.0%} queries / {args.update_frac:.0%} updates)")

    r = run_engine_batched(engine, args.ops, args.update_frac, args.batch)
    print(f"engine bua_qf (batch={args.batch}): {r['ops_per_s']:,.0f} ops/s "
          f"(x{r['ops_per_s'] / base['bua_qf']:.1f} vs scalar loop); "
          f"queries alone {r['queries_per_s']:,.0f}/s, "
          f"updates alone {r['updates_per_s']:,.0f}/s")
    print("engine stats:", engine.stats())

    print(f"\nmoving fleet: {args.fleet_size} vehicles on shortest-path trips, "
          f"{args.ticks} serving ticks (one fused stage_move flush per tick)")
    f = run_fleet(g, bn, args.k, args.fleet_size, args.ticks, args.batch, device)
    es = f["engine"].stats()
    print(f"fleet: {f['ticks_per_s']:.1f} ticks/s at "
          f"{f['moves_per_tick']:.0f} moves/tick; query p50 "
          f"{f['query_p50_us']:.0f} us / p99 {f['query_p99_us']:.0f} us "
          f"while flushing")
    print(f"fleet engine: {es['moves_applied']} moves applied, "
          f"{es['coalesced']} staged ops coalesced away, "
          f"{es['rows_repaired']} rows repaired")
    # the batched engine and the scalar loop served the same index: after
    # their own traffic, the engine must still equal a fresh build on its
    # object set (the fleet engine likewise)
    for name, eng in (("engine", engine), ("fleet", f["engine"])):
        want = knn.knn_index_cons_plus(bn, eng.objects, args.k)
        ok = knn.indices_equivalent(eng.to_index(), want)
        print(f"{name} tables equal a rebuild on its objects: {ok}")
        if not ok:
            raise SystemExit(1)
    return {"scalar": base, "engine": r,
            "fleet": {key: val for key, val in f.items() if key != "engine"}}


if __name__ == "__main__":
    main()
