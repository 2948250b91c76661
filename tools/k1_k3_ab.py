"""Times K1 and K3 of two checkouts of the port on one card, in turns.

    python3 tools/k1_k3_ab.py --other DIR [--reps 20]

In the order other, this, this, other, runs one process per turn with that
checkout's ``src`` on the path. Each makes the same inputs from fixed seeds
(this checkout's ``chip_smoke.py`` case makers), and times with CUDA events
(median of ``reps`` warm launches):

- K1 ``topk_merge`` at the usa shape (B = 131,072, C = k + 64 = 84, k = 20)
  and at the flush's wide shape (C = k + 512);
- K3 ``frontier_relax`` (the JAX package's signature, which every checkout
  has) at the usa shape (n = 2^24, R = 131,072, T = 32, B = 64) and at a
  flush's shape (n = 147,456, R = 16,384, T = 32, B = 476).

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
K = 20


def measure(reps: int) -> dict:
    """In the checkout whose ``src`` is first on the path."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    _build.build_all()

    def timed(fn) -> tuple[float, str]:
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(x.cpu().numpy().tobytes() for x in
                                         (out if isinstance(out, tuple) else (out,))))
        return cs.cuda_ms(fn, reps=reps, warm=2), digest.hexdigest()[:16]

    readings = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    for c in (K + 64, K + 512):
        ids = torch.randint(-1, 96 if c < 128 else 600, (131072, c), generator=gen, device=dev,
                            dtype=torch.int32)
        d = torch.randint(0, 32 if c < 128 else 256, (131072, c), generator=gen,
                          device=dev).to(torch.float32)
        readings[f"topk_merge C={c}"] = timed(lambda: ops.topk_merge(ids, d, K))
        del ids, d
    for name, (seed, n, r, t, b) in {"usa": (13, 1 << 24, 131072, 32, 64),
                                      "flush": (14, 147456, 16384, 32, 476)}.items():
        case = cs.frontier_case(dev, seed, n, r, t, b)
        readings[f"frontier_relax {name} R={r} T={t} B={b}"] = timed(
            lambda: ops.frontier_relax(*case))
        del case
        torch.cuda.empty_cache()
    return {key: {"ms": ms, "digest": digest} for key, (ms, digest) in readings.items()}


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
        print("k1_k3_ab: no CUDA device", file=sys.stderr)
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
        print("k1_k3_ab: the checkouts gave different results", file=sys.stderr)
    return 1 if bad or len(digests) > 1 else 0


if __name__ == "__main__":
    sys.exit(main())
