"""Quickstart: the paper end to end, the port's twin of the JAX package's
``examples/quickstart.py`` (all thirteen sections).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a synthetic road network, constructs the KNN-Index with the
bidirectional algorithm (host reference AND the level-synchronous device
sweeps), answers queries progressively, maintains the index through object
insertions/deletions, serves batched traffic through the ``repro_torch.knn``
QueryEngine facade, runs the moving-fleet workload, the vertex-sharded engine
(S logical shards of one padded table on one device, where the JAX package
puts one shard on each device), the durability surface (epochs, pinned reads,
journal recovery), replicated hot shards, uneven shard ranges and the
collective halo exchange.

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain versions of the kernels. Exits 1 if any equivalence it prints is False.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch import knn
from repro_torch.core.construct import prepare_sweep
from repro_torch.core.index import indices_equivalent
from repro_torch.core.reference import knn_index_cons_plus
from repro_torch.core.updates import delete_object, insert_object
from repro_torch.device import resolve_device
from repro_torch.graph.generators import pick_objects, road_network


# shards of sections 8, 11-13: the JAX example's min(2, devices) where it has
# two devices or more
SHARDS = 2


def _same(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a.cpu()), np.asarray(b.cpu())))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    checks: dict[str, bool] = {}

    k = 10
    print("== 1. road network ==")
    g = road_network(40, 40, seed=0)
    objects = pick_objects(g.n, mu=0.02, seed=0)
    print(f"n={g.n} m={g.m} |M|={len(objects)} k={k} device={device}")

    print("\n== 2. BN-Graph (Algorithm 1) ==")
    bn = knn.build_bngraph(g)
    plan = prepare_sweep(bn, "up", device=device)
    print(f"rho={bn.rho} tau={bn.tau} levels={plan.num_levels} "
          f"shape-buckets={len(plan.buckets)} pad-occupancy={plan.occupancy:.2f}")

    print("\n== 3. construction: Algorithm 3 (host) vs level-sync sweeps (device) ==")
    idx_host = knn_index_cons_plus(bn, objects, k)
    idx_dev = knn.build_knn_index(bn, objects, k, device=device)
    checks["construction"] = indices_equivalent(idx_host, idx_dev)
    print(f"identical results: {checks['construction']}")
    print(f"index size: {idx_dev.size_bytes(dist_bytes=4) / 1024:.1f} KiB "
          f"(= n*k*8 bytes on device, Theorem 4.5)")

    print("\n== 4. queries (O(k), progressive) ==")
    u = 777
    print(f"kNN({u}) = {idx_dev.query(u, 5)}")
    print("progressive:", end=" ")
    for i, (v, d) in enumerate(idx_dev.query_progressive(u, 3)):
        print(f"#{i + 1}:({v},{d:.0f})", end=" ")
    print()

    print("\n== 5. maintenance (Algorithms 4/5) ==")
    new_obj = int(np.setdiff1d(np.arange(g.n), objects)[0])
    delta = insert_object(bn, idx_dev, new_obj)
    print(f"insert {new_obj}: {delta} rows touched; kNN({u}) = {idx_dev.query(u, 5)}")
    delta = delete_object(bn, idx_dev, new_obj)
    print(f"delete {new_obj}: {delta} rows touched")
    checks["maintenance"] = indices_equivalent(idx_host, idx_dev)
    print(f"back to original: {checks['maintenance']}")

    print("\n== 6. serving (repro_torch.knn facade: batched device-resident engine) ==")
    engine = knn.build_engine(bn, objects, k, device=device)
    us = np.arange(0, g.n, 7, dtype=np.int32)
    ids, dists = engine.query_batch(us)              # one gather, whole batch
    print(f"query_batch({len(us)} queries): ids {tuple(ids.shape)}, "
          f"first row {ids[0, :3].tolist()}")
    for prefix_ids, _ in engine.query_progressive_batch(us[:4], 3):
        pass                                          # first-i prefixes, one gather
    print(f"progressive prefixes up to i={prefix_ids.shape[1]} for "
          f"{prefix_ids.shape[0]} queries")
    engine.stage_insert(new_obj)                      # queued, not yet visible
    print(f"staged queue depth: {engine.queue_depth}; "
          f"flush: {engine.flush_updates()}")
    path = os.path.join(tempfile.mkdtemp(), "index.npz")
    engine.save(path)                                 # same artifact knn_build --out writes
    engine2 = knn.load_engine(path, bn=bn, device=device)
    checks["save_load"] = indices_equivalent(engine.to_index(), engine2.to_index())
    print(f"save/load round-trip equivalent: {checks['save_load']}")
    print(f"engine stats: {engine.stats()}")

    print("\n== 7. moving fleet (build -> simulate -> query while moving) ==")
    sim = knn.FleetSim(g, fleet_size=64, seed=0)      # vehicles on sp trips
    fleet_engine = knn.build_engine(bn, sim.positions, k, device=device)
    for _ in range(3):                                # one serving tick each
        moves = sim.tick()                            # vehicles advance a street
        for src, dst in moves:
            fleet_engine.stage_move(src, dst)         # staged, not yet visible
        fleet_engine.query_batch(us[:64])             # queries see flushed state
        stats = fleet_engine.flush_updates()          # one fused move batch
    print(f"tick: {len(moves)} moves staged -> flush {stats}")
    print(f"fleet sim: {sim.stats()}")

    print("\n== 8. sharded serving (vertex-partitioned engine) ==")
    # The flat (n+1, k) table is embarrassingly partitionable by vertex:
    # shard s owns the contiguous range [s*R, (s+1)*R), R = ceil(n/S). Here
    # the S shards are logical blocks of one padded table on one device
    # (the JAX package puts one block on each device of a 1-D mesh): queries
    # route to their owner shard, flushes run per shard with only frontier
    # rows crossing shard boundaries between repair rounds.
    shards = SHARDS
    sharded = knn.build_sharded_engine(bn, objects, k, shards=shards, device=device)
    s_ids, _ = sharded.query_batch(us)                # routed gather
    checks["sharded"] = _same(s_ids, ids)
    print(f"shards={shards} (logical, one device); "
          f"bit-identical to scalar engine: {checks['sharded']}")
    st = sharded.stats()
    print(f"shard rows={st['shard_rows']} padded rows={st['padded_rows']} "
          f"(overhead {st['row_padding_overhead']:.2%})")
    sharded.save(path)                                # artifact is shard-free
    resharded = knn.load_engine(path, bn=bn, shards=1, device=device)   # reshard-on-load
    checks["reshard"] = indices_equivalent(sharded.to_index(), resharded.to_index())
    print(f"reshard-on-load equivalent: {checks['reshard']}")

    print("\n== 9. batched checkIns frontier (device-resident insert flushes) ==")
    # A flush with many staged inserts runs Algorithm 4's checkIns frontier
    # for the WHOLE batch as one multi-source pruned-relaxation program on
    # the device (K3 frontier_relax rounds); engine.frontier = "host" keeps
    # the one-heap-search-per-object pipeline, with identical tables.
    batch_engine = knn.build_engine(bn, objects, k, device=device)
    absent = np.setdiff1d(np.arange(g.n), objects)[:64]
    for v in absent:
        batch_engine.stage_insert(int(v))
    flush = batch_engine.flush_updates()
    print(f"staged {len(absent)} inserts -> one flush: "
          f"{flush['rows_merged']} rows merged in "
          f"{flush['frontier_rounds']} frontier rounds")
    st = batch_engine.stats()
    print("per-phase flush seconds: "
          f"frontier={st['t_frontier_s']:.4f} "
          f"purge_merge={st['t_purge_merge_s']:.4f} "
          f"repair={st['t_repair_s']:.4f}")

    print("\n== 10. durability & epochs (crash-safe serving) ==")
    # Every flush publishes a new immutable epoch; keep_epochs retains older
    # ones for pinned reads (query_batch(..., epoch=e)). A write-ahead
    # journal makes staged updates durable BEFORE they are acknowledged: a
    # process killed mid-flush replays it on load and recovers identical
    # tables.
    wal = os.path.join(tempfile.mkdtemp(), "updates.wal")
    dur = knn.load_engine(path, bn=bn, journal=wal, device=device)   # journal from here on
    dur.keep_epochs = 3
    pinned = dur.epoch                                # epoch to time-travel to
    before = dur.query_batch(us)[0]
    dur.stage_insert(int(np.setdiff1d(np.arange(g.n), dur.objects)[0]))
    dur.flush_updates()                               # journal commit + swap
    print(f"epoch {pinned} -> {dur.epoch}; retained={dur.retained_epochs()}; "
          f"origin={dur.epoch_stats()['origin']}")
    old = dur.query_batch(us, epoch=pinned)[0]
    checks["pinned"] = _same(old, before)
    print(f"pinned read of epoch {pinned} unchanged: {checks['pinned']}")
    rec = knn.load_engine(path, bn=bn, journal=wal, device=device)
    checks["replay"] = bool(np.array_equal(rec.to_index().ids, dur.to_index().ids))
    print(f"journal replay recovers epoch {rec.epoch}: bit-identical {checks['replay']}")
    try:                                              # corruption is typed
        knn.UpdateJournal(path)                       # npz is not a journal
    except knn.JournalError as e:
        print(f"typed corruption error: JournalError: {e}")
    print(f"epoch stats: {dur.stats()['epochs_retained']} retained, "
          f"{dur.stats()['epoch_table_bytes']} table bytes")

    print("\n== 11. replicated hot shards (shard -> replica-set fan-out) ==")
    # set_replication({shard: R}) copies the hot shard's epoch buffers R
    # times at publish time (on one device: R more buffers on the card,
    # never refused for want of devices), and query batches fan out across
    # the replica set (round_robin or least_outstanding). Flushes still go
    # to the primary only.
    hot = 0
    sharded.set_replication({hot: 3}, policy="round_robin")
    r_ids, _ = sharded.query_batch(us)
    rst = sharded.stats()
    checks["replicas"] = _same(r_ids, ids)
    print(f"plan {rst['replication']} -> {rst['replica_slots']} slots "
          f"({rst['replica_policy']}); bit-identical through replicas: {checks['replicas']}")
    print(f"replica traffic: {rst['replica_queries']} queries in "
          f"{rst['replica_batches']} batches, errors={rst['replica_errors']}")
    sharded.set_replication(None)                     # drop back to primaries

    print("\n== 12. uneven shard ranges (traffic-aware repartition) ==")
    # propose_starts turns a per-vertex query histogram into balanced
    # boundaries; repartition() stages them for the next flush and publishes
    # the new layout in one atomic epoch step, so pinned reads on older
    # epochs keep serving under their old boundaries.
    if sharded.num_shards > 1:
        hist = np.bincount(np.repeat(us, 3), minlength=g.n).astype(np.float64)
        starts = knn.propose_starts(hist, sharded.num_shards)
        pinned = sharded.epoch
        sharded.repartition(starts)                   # stage + flush in one
        u_ids, _ = sharded.query_batch(us)
        pst = sharded.stats()
        print(f"boundaries {pst['shard_starts']} (uneven={pst['uneven_ranges']}, "
              f"repartitions={pst['repartitions']})")
        old_ids = sharded.query_batch(us, epoch=pinned)[0]
        checks["repartition"] = _same(u_ids, ids) and _same(old_ids, ids)
        print(f"bit-identical after repartition: {_same(u_ids, ids)}; "
              f"pinned epoch {pinned} still serves the old layout: {_same(old_ids, ids)}")
        plan = knn.PartitionPlan.parse(f"shards={sharded.num_shards}")
        print(f"plan surface: {sharded.partition_plan().describe()} "
              f"(parse('shards=N') == legacy shards=N: "
              f"{plan.shards == sharded.num_shards})")
    else:
        print("single shard - boundaries have nowhere to move")

    print("\n== 13. collective halo exchange (device-resident flush repair) ==")
    # Multi-shard flushes need a halo: rows changed on one shard make their
    # BNS neighbourhoods, wherever they live, the next round's candidates.
    # halo="collective" (the default) keeps them on the device: a presence
    # mask summed over the shards and capacity-padded slabs gathered across
    # them; a round too wide for engine.halo_capacity takes the routed host
    # path for that round only (stats()['halo_fallbacks']).
    if sharded.num_shards > 1:
        sharded.stage_insert(int(np.setdiff1d(np.arange(g.n), sharded.objects)[0]))
        sharded.flush_updates()
        hst = sharded.stats()
        print(f"halo={hst['halo']}: {hst['halo_rounds_collective']} collective "
              f"rounds, {hst['halo_fallbacks']} overflow fallbacks")
        want = knn_index_cons_plus(bn, sharded.objects, k)
        checks["halo"] = indices_equivalent(sharded.to_index(), want)
        print(f"tables equal a rebuild on the new object set: {checks['halo']}")
    else:
        print("single shard - nothing crosses a boundary")
    # The kernels are built at first use into build/ (or the directory
    # serve.py --compile-cache DIR / REPRO_COMPILE_CACHE names); a second
    # process over the same directory builds nothing:
    #     from repro_torch.analysis import sanitize
    #     sanitize.enable_compile_cache("~/.cache/repro-kernels")

    failed = sorted(name for name, ok in checks.items() if not ok)
    print(f"\nchecks: {len(checks) - len(failed)} of {len(checks)} hold"
          + (f"; failed: {failed}" if failed else ""))
    if failed:
        raise SystemExit(1)
    return checks


if __name__ == "__main__":
    main()
