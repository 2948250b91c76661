"""Times K3 frontier_relax's launch shapes against each other on one card.

    python3 tools/k3_variants.py [--reps 10]

Builds copies of ``csrc/frontier_relax.cu`` in a temporary directory with
kBatch (the neighbour rows a warp loads at once) set to 2, 4 and 8, and times
every V (columns a lane reads at once) that B allows, each with a warp a
receiver row (split 0) and a warp a (row, column chunk) (split 1), with CUDA
events (median of ``reps`` warm launches). Shapes: the ``knn-index-usa`` one
(n = 2^24, R = 131,072, T = 32, B = 64), a flush's narrow and T = 128
buckets at grid 384 (n = 147,456, B = 472), and its highest-degree bucket
(2,780 rows of 130-677 neighbours in T = 775, 70% of them from 5,000 shared
vertices, as hubs share neighbours). Every variant is held to the plain
version, exactly. Prints the card's name and power limit, then one JSON line
a shape, the launch shape that ``ops.frontier_plan`` picks marked with a
``*``. Exits 1 if a variant differs from the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (2, 4, 8)


def hub_case(dev, seed: int, n: int, r: int, t: int, b: int):
    """A highest-degree bucket: 130-677 neighbours a row, 70% of them drawn
    from 5,000 shared vertices."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dist = torch.rand((n + 1, b), generator=gen, device=dev) * 100.0
    dist[torch.rand((n + 1, b), generator=gen, device=dev) < 0.6] = float("inf")
    dist[n] = float("inf")
    kth = torch.rand((n + 1,), generator=gen, device=dev) * 100.0
    kth[n] = float("inf")
    rows = rng.choice(n, size=r, replace=False).astype(np.int32)
    pool = rng.choice(n, size=5000, replace=False)
    nbr = np.where(rng.random((r, t)) < 0.7, pool[rng.integers(0, 5000, size=(r, t))],
                   rng.integers(0, n, size=(r, t))).astype(np.int32)
    nbr[np.arange(t)[None, :] >= rng.integers(130, 678, size=r)[:, None]] = -1
    w = np.where(nbr >= 0, rng.integers(1, 16, size=(r, t)), np.inf).astype(np.float32)
    src = nbr[:b, 0].copy()
    src[-3:] = -1
    dist[:, -3:] = float("inf")
    return (*(torch.from_numpy(x).to(dev) for x in (nbr, rows, w)), dist, kth,
            torch.from_numpy(src).to(dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    source = (_build.CSRC / "frontier_relax.cu").read_text()
    anchor = "constexpr int kBatch = 2;"
    if source.count(anchor) != 1:
        raise SystemExit(f"k3_variants: {anchor!r} is not in frontier_relax.cu once")
    libs = {}
    with tempfile.TemporaryDirectory(prefix="k3_variants_") as tmp:
        procs = {}
        for batch in BATCHES:
            path = os.path.join(tmp, f"frontier_relax_b{batch}.cu")
            with open(path, "w") as f:
                f.write(source.replace(anchor, f"constexpr int kBatch = {batch};"))
            procs[batch] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                 os.path.join(tmp, f"lib_b{batch}.so"), path],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for batch, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"k3_variants: nvcc failed for kBatch = {batch}\n{err}")
            fn = ctypes.CDLL(os.path.join(tmp, f"lib_b{batch}.so")).knn_frontier_relax
            fn.argtypes, fn.restype = ops._SIGNATURES["knn_frontier_relax"]
            libs[batch] = fn

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = {
        "usa R=131072 T=32 B=64": lambda: cs.frontier_case(dev, 13, 1 << 24, 131072, 32, 64),
        "flush R=98241 T=8 B=472": lambda: cs.frontier_case(dev, 20, 147456, 98241, 8, 472),
        "flush R=10961 T=128 B=472": lambda: cs.frontier_case(dev, 22, 147456, 10961, 128, 472),
        "flush hubs R=2780 T=775 B=472": lambda: hub_case(dev, 23, 147456, 2780, 775, 472),
    }
    bad = False
    for name, make in shapes.items():
        nbr, rows, w, dist, kth, src = case = make()
        r, t = nbr.shape
        b = dist.shape[1]
        want = ref.frontier_relax_ref(*case)
        out = torch.empty((r, b), dtype=torch.float32, device=dev)
        plan = ops.frontier_plan(r, b, dist.data_ptr(), ops.resident_warps(dev))
        reading = {}
        for batch, fn in libs.items():
            for vec in (v for v in (1, 2, 4) if b % v == 0):
                for split in (0, 1):
                    def run(fn=fn, vec=vec, split=split):
                        code = fn(nbr.data_ptr(), rows.data_ptr(), w.data_ptr(), dist.data_ptr(),
                                  kth.data_ptr(), src.data_ptr(), out.data_ptr(), r, t, b, vec,
                                  split, stream)
                        if code:
                            raise RuntimeError(f"k3_variants: launch failed with {code}")
                    run()
                    torch.cuda.synchronize()
                    same = torch.equal(out, want)
                    bad |= not same
                    key = f"b{batch}/v{vec}/s{split}" + ("*" if (batch, vec, split) == (2, *plan)
                                                         else "")
                    reading[key] = {"ms": cs.cuda_ms(run, reps=args.reps, warm=2), "equal": same}
        print(json.dumps({"shape": name, "bound_ms": cs.frontier_bound(nbr, b)[0], **reading}),
              flush=True)
        del case, nbr, rows, w, dist, kth, src, want, out
        torch.cuda.empty_cache()
    if bad:
        print("k3_variants: a variant differs from the plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
