"""Recsys retrieval example: score one query against a large candidate table
and take the exact top-k, with the plain PyTorch version and with the K5
kernel, and check that the two agree.

    PYTHONPATH=src python -m repro_torch.examples.retrieval_recsys \\
        --candidates 1000000 --k 100

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain version twice, ``--no-use-kernel`` runs it twice on the card. Prints the
JAX example's lines, then one JSON line with both times; exits 1 if the two
answers differ.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops
from repro_torch.models import recsys as rc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction, default=True,
                    help="the K5 kernel (default) or, with --no-use-kernel, its plain version")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = rc.XDeepFMConfig(
        name="retrieval-demo", n_sparse=8, embed_dim=16,
        table_rows=args.candidates, cin_layers=(32, 32), mlp_layers=(64,),
    )
    params = rc.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.table_rows, (1, cfg.n_sparse, cfg.bag_size)).astype(np.int32)
    batch = {"sparse_ids": ids, "n_candidates": args.candidates}

    def timed(use_kernel: bool):
        rc.retrieval_score(params, batch, cfg, k=args.k, device=device, use_kernel=use_kernel)
        synchronize(device)  # warm: kernel build and load, library handles
        t0 = time.perf_counter()
        out = rc.retrieval_score(params, batch, cfg, k=args.k, device=device,
                                 use_kernel=use_kernel)
        synchronize(device)
        return out, time.perf_counter() - t0

    (oid, od), t_plain = timed(False)
    print(f"top-{args.k} of {args.candidates:,} candidates in {t_plain * 1e3:.1f}ms "
          f"(plain PyTorch, {device})")
    print("ids   :", oid.cpu().numpy()[0, :8])
    print("scores:", np.round(od.float().cpu().numpy()[0, :8], 3))

    ops.reset_launches()
    (oid2, od2), t_kernel = timed(args.use_kernel)
    match = bool(np.array_equal(oid.cpu().numpy(), oid2.cpu().numpy())
                 and np.array_equal(od.cpu().numpy(), od2.cpu().numpy()))
    what = "CUDA kernel" if args.use_kernel and device.type == "cuda" else "plain version"
    print(f"{what} agrees with plain version: {match}")
    stats = {"device": str(device), "candidates": args.candidates, "k": args.k,
             "plain_ms": t_plain * 1e3, "ms": t_kernel * 1e3, "path": what,
             "agrees": match, "launches": ops.launches()}
    print(json.dumps(stats))
    if not match:
        raise SystemExit(1)
    return stats


if __name__ == "__main__":
    main()
