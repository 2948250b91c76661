"""Times K5 of two checkouts of the port on one card, in turns.

    python3 tools/k5_ab.py --other DIR [--reps 20]

In the order other, this, this, other, runs one process per turn with that
checkout's ``src`` on the path. Each makes the same inputs from fixed seeds
and times ``ops.retrieval_topk`` (the wrapper every checkout has) with CUDA
events, the median of ``reps`` warm calls, one call between two events:

- at the retrieval cell's (1, 10^6, k = 100), random scores;
- at (512, 10^6, 100), the batched nearest-object rows;
- at (1, 10^6, 1024);
- at (1, 10^6, 100) on ascending scores (every score beats the ones before).

It prints each result's digest: every turn must give the same results. The
kernels of each checkout are built in its own ``build/`` directory.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per turn. Exits 1 if a turn fails or the results differ.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1_000_000


def measure(reps: int) -> dict:
    """In the checkout whose ``src`` is first on the path."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    _build.build_all()
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = {
        "random (1, 10^6, 100)": (torch.randn((1, N), generator=gen, device=dev), 100),
        "random (512, 10^6, 100)": (torch.randn((512, N), generator=gen, device=dev), 100),
        "random (1, 10^6, 1024)": (torch.randn((1, N), generator=gen, device=dev), 1024),
        "ascending (1, 10^6, 100)": (torch.arange(N, dtype=torch.float32, device=dev)[None], 100),
    }
    readings = {}
    for name, (s, k) in cases.items():
        ops.reset_launches()
        ids, scores = ops.retrieval_topk(s, k)
        torch.cuda.synchronize()
        launches = ops.launches()["retrieval_topk"]
        digest = hashlib.sha256(ids.cpu().numpy().tobytes() + scores.cpu().numpy().tobytes())
        readings[name] = {"ms": cs.cuda_ms(lambda: ops.retrieval_topk(s, k), reps=reps, warm=2),
                          "launches_per_call": launches, "digest": digest.hexdigest()[:16]}
    return readings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.reps)))
        return 0
    if not args.other:
        ap.error("--other is required")

    import torch

    if not torch.cuda.is_available():
        print("k5_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    other = os.path.abspath(args.other)
    digests, bad = set(), False
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900, cwd=tree,
            env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")))
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            bad = True
            continue
        reading = json.loads(run.stdout.strip().splitlines()[-1])
        digests.add(json.dumps({key: val["digest"] for key, val in reading.items()}))
        print(json.dumps({"checkout": label, "root": tree, **reading}), flush=True)
    if len(digests) > 1:
        print("k5_ab: the checkouts gave different results", file=sys.stderr)
    return 1 if bad or len(digests) > 1 else 0


if __name__ == "__main__":
    sys.exit(main())
