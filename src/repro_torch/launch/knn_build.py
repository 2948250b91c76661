"""KNN-Index build command (the paper's pipeline, end to end):

  road network -> min-degree order + BN-Graph (host symbolic phase)
               -> level-synchronous device sweeps (bottom-up V_k^<, top-down V_k)
               -> QueryEngine + stats

  PYTHONPATH=src python -m repro_torch.launch.knn_build --grid 256 --k 20 --verify

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import knn
from repro_torch.core.construct import build_knn_tables, prepare_sweep, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=60, help="grid side; n = grid^2")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--mu", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--use-kernel", action=argparse.BooleanOptionalAction, default=True,
        help="CUDA kernels (default) or, with --no-use-kernel, their plain versions",
    )
    ap.add_argument("--verify", action="store_true", help="check vs host reference")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    g = knn.road_network(args.grid, args.grid, seed=args.seed)
    objects = knn.pick_objects(g.n, args.mu, seed=args.seed)
    t1 = time.perf_counter()
    bn = knn.build_bngraph(g)
    t2 = time.perf_counter()
    # prepare the sweep schedules once: they drive the build AND the stats
    up = prepare_sweep(bn, "up", device=device)
    down = prepare_sweep(bn, "down", device=device)
    vk_ids, vk_d = build_knn_tables(
        bn, objects, args.k, device=device, use_kernel=args.use_kernel, plans=(up, down)
    )
    engine = knn.QueryEngine(
        vk_ids, vk_d, args.k, objects, bn=bn, device=device, use_kernel=args.use_kernel
    )
    idx = engine.to_index()  # the readback also waits for the device
    t3 = time.perf_counter()
    stats = {
        "device": str(device),
        "n": g.n,
        "m": g.m,
        "|M|": int(objects.size),
        "k": args.k,
        "rho": bn.rho,
        "tau": bn.tau,
        "levels_up": up.num_levels,
        "levels_down": down.num_levels,
        # a chunk of device work is one launch here, and a sweep launches once per level
        "chunks_up": up.num_levels,
        "chunks_down": down.num_levels,
        "shape_buckets_up": len(up.buckets),
        "shape_buckets_down": len(down.buckets),
        "pad_occupancy_up": round(up.occupancy, 4),
        "pad_occupancy_down": round(down.occupancy, 4),
        "gen_s": round(t1 - t0, 3),
        "bngraph_s": round(t2 - t1, 3),
        "sweeps_s": round(t3 - t2, 3),
        # the paper's n*k*(4+4)-byte count = what the device tables occupy
        "index_bytes": idx.size_bytes(dist_bytes=4),
    }
    if args.verify:
        ref = knn.knn_index_cons_plus(bn, objects, args.k)
        stats["verified"] = bool(knn.indices_equivalent(ref, idx))
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
