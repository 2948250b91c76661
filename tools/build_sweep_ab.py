"""Times the construction sweeps of two checkouts of the port on one card, in turns.

    python3 tools/build_sweep_ab.py --other DIR [--grid 384] [--k 20] [--reps 5]
                                    [--bngraph FILE]

Builds the BN-Graph of ``road_network(grid, grid, seed=0)`` once with this
checkout's package and writes its arrays to a temporary file (``--bngraph``:
loads them from FILE instead, a ``.npz`` of the BN-Graph's fields such as
the benchmark keeps in ``knnbench/.cache/``). Then, in the
order other, this, this, other, runs one process per turn with that checkout's
``src`` on the path, which loads the BN-Graph, packs and uploads both sweep
schedules (``prepare_sweep``) ``reps`` times, runs ``build_knn_tables`` once
cold and ``reps`` times warm, and prints: the schedules' host seconds
(``build_host_s``, median, as ``chip_smoke.py``'s main path names it) and the
process's peak resident memory after them, the cold build's host seconds,
the warm builds' host seconds and CUDA-event milliseconds (median), the K2
launches of one build, the cold build's trace counters (K2's tally among
them), and a digest of the tables (every turn must give the same tables). The
kernels of each checkout are built in its own ``build/`` directory.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per turn. Exits 1 if a turn fails or the tables differ.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECT_SHARE = 0.01


def measure(bn_path: str, grid: int, reps: int, k: int) -> dict:
    """In the checkout whose ``src`` is first on the path."""
    import numpy as np
    import torch

    from repro_torch import knn, trace
    from repro_torch.core.bngraph import bngraph_from_arrays
    from repro_torch.core.construct import build_knn_tables, prepare_sweep
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    _build.build_all()
    with np.load(bn_path) as z:
        bn = bngraph_from_arrays(**{name: z[name] for name in z.files})
    objects = knn.pick_objects(bn.n, OBJECT_SHARE, seed=0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    plan_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plans = (prepare_sweep(bn, "up", device=dev), prepare_sweep(bn, "down", device=dev))
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t0)
    peak_mib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    ops.reset_launches()
    t0 = time.perf_counter()
    ids, d = build_knn_tables(bn, objects, k, device=dev, plans=plans)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counters = trace.last("repro_torch.build_knn_tables")
    launches = {name: n for name, n in ops.launches().items() if n}
    digest = hashlib.sha256(ids.cpu().numpy().tobytes() + d.cpu().numpy().tobytes()).hexdigest()
    host, device = [], []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        build_knn_tables(bn, objects, k, device=dev, plans=plans)
        e1.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        device.append(e0.elapsed_time(e1))
    return {"grid": grid, "n": bn.n, "k": k, "levels": [p.num_levels for p in plans],
            "build_host_s": statistics.median(plan_s), "build_host_s_all": plan_s,
            "peak_rss_mib_after_plans": peak_mib, "cold_host_s": cold_s, "warm_host_s": statistics.median(host),
            "warm_event_ms": statistics.median(device), "warm_event_ms_all": device,
            "launches": launches, "counters": counters,
            "k2_grid": ops._fn("sweep_merge", "knn_sweep_levels_grid")(k), "tables_sha256": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--grid", type=int, default=384)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bngraph", help="a .npz of the BN-Graph's fields, loaded, not built")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.grid, args.reps, args.k)))
        return 0
    if not args.other:
        ap.error("--other is required")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("build_sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import knn

    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory(prefix="sweep_ab_") as tmp:
        bn_path = os.path.abspath(args.bngraph) if args.bngraph else os.path.join(tmp, "bn.npz")
        if not args.bngraph:
            t0 = time.perf_counter()
            bn = knn.build_bngraph(knn.road_network(args.grid, args.grid, seed=0))
            print(json.dumps({"bngraph_s": time.perf_counter() - t0, "n": bn.n}), flush=True)
            np.savez(bn_path, **{f.name: getattr(bn, f.name) for f in dataclasses.fields(bn)})
        digests, bad = set(), False
        for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure", bn_path,
                 "--grid", str(args.grid), "--reps", str(args.reps), "--k", str(args.k)],
                capture_output=True, text=True, timeout=900, cwd=tree,
                env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")))
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                bad = True
                continue
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            digests.add(reading["tables_sha256"])
            print(json.dumps({"checkout": label, "root": tree, **reading}), flush=True)
    if len(digests) > 1:
        print("build_sweep_ab: the checkouts built different tables", file=sys.stderr)
    return 1 if bad or len(digests) > 1 else 0


if __name__ == "__main__":
    sys.exit(main())
