"""Serving driver, dispatched by architecture family.

LM archs (``qwen2.5-3b``): batched prefill, then an autoregressive decode
loop; the prefill's attention is the K6 kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --batch 4 --prompt-len 2048 --gen 32

It prints the JAX driver's two lines (prefill and decode times, the first
sequence's tokens) and one JSON line: prefill ms, decode tokens/s and the
kernels' launch counts. Weights are random, drawn on the device from seed 0;
the times are of a warm run (one untimed prefill and decode step before it).

kNN archs (``knn-index``): a device-resident ``QueryEngine`` under mixed
traffic (batched queries + staged object updates, the paper's
batch-update-arrival model):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch knn-index \\
      --grid 141 --k 20 --artifact index.npz --ops 200000 --update-frac 0.05

As in the JAX package, ``serve.py`` does not serve the recsys family; its
entry point is ``python -m repro_torch.examples.retrieval_recsys``.

The kNN loop builds (or loads, ``--artifact``, a ``knn_build --out`` npz of either
package) the index, then serves rounds of ``query_batch`` with updates staged
into the engine's queue and flushed once per round, printing queries/s,
updates/s and the engine's serving stats as JSON. Without ``--grid`` the
network has the configuration's size (``--smoke``: 23 x 23, k = 5; otherwise
the 2^24-vertex ``knn-index-usa`` network, far beyond what the host BN-Graph
pass builds in reasonable time, so pass ``--grid``).

``--workload fleet`` swaps the random insert/delete churn for the
moving-objects workload: a ``FleetSim`` drives vehicles along shortest-path
trips, each serving tick stages the tick's (src, dst) moves via
``stage_move`` and flushes them as one fused batch while query batches
interleave. Reports sustained ticks/s and query p50/p99:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch knn-index \\
      --grid 141 --k 20 --workload fleet --fleet-size 200 --ticks 20

``--seed`` seeds everything host-side: the network, the object draw, the
query stream and the staged-update stream, so two runs with the same seed
serve the identical op sequence.

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead, ``--no-use-kernel`` runs them
on the card. Only the scalar engine exists in this package: the JAX
package's sharded flags (``--partition``, ``--shards``, ``--replicate``,
``--hot-*``, ``--rebalance-*``) and its XLA ``--compile-cache`` have no
counterpart here.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import knn
from repro_torch.configs import knn_index
from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops
from repro_torch.workloads import drive_fleet_ticks


def _next_tokens(logits: torch.Tensor, temperature: float, gen: torch.Generator):
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(logits, dim=-1)


def serve_lm(args) -> dict:
    """Batched prefill + greedy (or sampled) decode loop."""
    from repro_torch.models import transformer as tr

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    params = tr.init_params(cfg, seed=0, device=device)
    max_len = args.prompt_len + args.gen
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), device=device,
                            generator=torch.Generator(device=device).manual_seed(1))

    # warm-up: kernel build and load, library handles, allocator
    logits, cache = tr.prefill(params, prompts, cfg, max_len, device=device,
                               use_kernel=args.use_kernel)
    tr.decode_step(params, cache, torch.argmax(logits, dim=-1), cfg)
    del logits, cache
    synchronize(device)

    ops.reset_launches()
    gen = torch.Generator(device=device).manual_seed(100)
    t0 = time.perf_counter()
    logits, cache = tr.prefill(params, prompts, cfg, max_len, device=device,
                               use_kernel=args.use_kernel)
    tokens = _next_tokens(logits, args.temperature, gen)
    synchronize(device)
    t_prefill = time.perf_counter() - t0
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = tr.decode_step(params, cache, tokens, cfg)
        tokens = _next_tokens(logits, args.temperature, gen)
        generated.append(tokens)
    synchronize(device)
    t_decode = time.perf_counter() - t0
    launches = ops.launches()

    out = torch.stack(generated, dim=1).cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"model {cfg.name}: prefill({args.batch}x{args.prompt_len}) "
          f"{t_prefill * 1e3:.1f} ms; decode {args.gen - 1} steps "
          f"{t_decode * 1e3:.1f} ms ({tps:.1f} tok/s)")
    print("generated token ids (first sequence):", out[0].tolist())
    stats = {
        "arch": args.arch, "model": cfg.name, "device": str(device),
        "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "params": cfg.param_count(), "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3, "decode_tok_per_s": tps, "launches": launches,
        "tokens": out.tolist(),
    }
    print(json.dumps({key: val for key, val in stats.items() if key != "tokens"}))
    return stats


def serve_knn_fleet(args, g, bn, k: int, batch: int, t_bn: float, device) -> dict:
    """Moving-fleet serving loop: fused ``stage_move`` flushes per tick."""
    sim = knn.FleetSim(g, fleet_size=args.fleet_size, seed=args.seed)
    t0 = time.perf_counter()
    engine = knn.QueryEngine.build(
        bn, sim.positions, k, device=device, use_kernel=args.use_kernel
    )
    synchronize(device)
    t_build = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed + 1)
    # warmup: the first gather outside the timed loop
    engine.query_batch(rng.integers(0, g.n, size=batch))
    synchronize(device)

    r = drive_fleet_ticks(
        engine, (sim.tick() for _ in range(args.ticks)), batch=batch, rng=rng
    )
    wall, lat = r["wall_s"], r["lat"]

    stats = {
        "arch": args.arch,
        "device": str(device),
        "workload": "fleet",
        "n": g.n,
        "k": k,
        "batch": batch,
        "fleet_size": sim.fleet_size,
        "ticks": args.ticks,
        "bngraph_s": round(t_bn, 3),
        "build_s": round(t_build, 3),
        "ticks_per_s": round(args.ticks / max(wall, 1e-9), 2),
        "moves_per_tick": round(sim.moves_total / max(args.ticks, 1), 1),
        "queries_per_s": round(args.ticks * batch / max(sum(lat), 1e-9), 1),
        "query_p50_us": round(float(np.percentile(lat, 50)) * 1e6, 1),
        "query_p99_us": round(float(np.percentile(lat, 99)) * 1e6, 1),
        "sim": sim.stats(),
        "engine": engine.stats(),
    }
    print(json.dumps(stats, indent=2))
    return stats


def _arm_injected_flush_failure(engine) -> None:
    """One-shot fault: the next flush dies just before its epoch swap (the
    worst-case point: all the work done, nothing published). Exercises the
    degrade-gracefully path end to end from the CLI."""

    def hook(e, phase):
        if phase == "pre-swap":
            e.checkpoint_hook = None
            raise RuntimeError("injected flush failure (--inject-flush-failure)")

    engine.checkpoint_hook = hook


def serve_knn(args) -> dict:
    """kNN serving loop: batched queries + staged updates on a QueryEngine."""
    device = resolve_device(args.device)
    cfg = knn_index.make_smoke() if args.smoke else knn_index.make_config()
    grid = args.grid or int(np.ceil(np.sqrt(cfg.n_vertices)))
    k = args.k or cfg.k

    batch = args.batch or min(cfg.query_batch, 4096)

    g = knn.road_network(grid, grid, seed=args.seed)
    objects = knn.pick_objects(g.n, args.mu, seed=args.seed)
    t0 = time.perf_counter()
    bn = knn.build_bngraph(g)
    t_bn = time.perf_counter() - t0
    if args.workload == "fleet":
        if args.artifact:
            # the fleet engine's object set must equal the sim's vehicle
            # positions, which a saved artifact cannot know about
            raise SystemExit("--artifact cannot be combined with --workload fleet")
        return serve_knn_fleet(args, g, bn, k, min(batch, 4096), t_bn, device)
    t0 = time.perf_counter()
    if args.artifact:
        # The artifact must come from the same (grid, seed) network: the
        # engine stores tables + objects, the BN-Graph supplies adjacency.
        engine = knn.load_engine(
            args.artifact, bn=bn, device=device, use_kernel=args.use_kernel
        )
        if engine.n != g.n or engine.k != k:
            raise SystemExit(
                f"artifact shape (n={engine.n}, k={engine.k}) does not match "
                f"--grid/--k (n={g.n}, k={k})"
            )
    else:
        engine = knn.QueryEngine.build(
            bn, objects, k, device=device, use_kernel=args.use_kernel
        )
    synchronize(device)
    t_build = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed + 1)
    mset = set(engine.objects.tolist())
    n_upd_round = int(round(batch * args.update_frac))
    rounds = max(1, args.ops // (batch + n_upd_round))

    # warmup: the first gather outside the timed loop
    engine.query_batch(rng.integers(0, g.n, size=batch))
    synchronize(device)

    # A failed flush (device error, corrupted batch, injected fault) must
    # not kill serving: the engine rolls back to the last good epoch with
    # the staged queue intact, so we log it, keep answering queries, and
    # retry the accumulated queue next round. --fail-fast restores the
    # die-on-first-error behaviour for debugging.
    t_query = t_update = 0.0
    queries = updates = 0
    errors = 0
    last_error = None
    for rnd in range(rounds):
        us = rng.integers(0, g.n, size=batch)
        t0 = time.perf_counter()
        engine.query_batch(us)
        synchronize(device)
        t_query += time.perf_counter() - t0
        queries += batch

        if n_upd_round:
            t0 = time.perf_counter()
            knn.stage_random_updates(engine, mset, rng, n_upd_round)
            depth = engine.queue_depth
            if args.inject_flush_failure and rnd + 1 == args.inject_flush_failure:
                _arm_injected_flush_failure(engine)
            try:
                engine.flush_updates()
                updates += depth
            except Exception as e:
                if args.fail_fast:
                    raise
                errors += 1
                last_error = f"{type(e).__name__}: {e}"
            finally:
                engine.checkpoint_hook = None
            synchronize(device)
            t_update += time.perf_counter() - t0

    wall = t_query + t_update
    stats = {
        "arch": args.arch,
        "device": str(device),
        "n": g.n,
        "k": k,
        "batch": batch,
        "rounds": rounds,
        "bngraph_s": round(t_bn, 3),
        "build_s": round(t_build, 3),
        "queries": queries,
        "updates": updates,
        "errors": errors,
        "last_error": last_error,
        "queries_per_s": round(queries / max(t_query, 1e-9), 1),
        "updates_per_s": round(updates / max(t_update, 1e-9), 1) if updates else 0.0,
        "ops_per_s": round((queries + updates) / max(wall, 1e-9), 1),
        "us_per_query": round(t_query / max(queries, 1) * 1e6, 3),
        "engine": engine.stats(),
    }
    print(json.dumps(stats, indent=2))
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="knn-index")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="lm: sequence batch (default 4); knn: query batch "
                         "(default min(config query_batch, 4096))")
    # --query-batch is an alias for --batch kept for the knn family
    ap.add_argument("--query-batch", type=int, default=None, dest="batch")
    # lm options
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    # knn options
    ap.add_argument("--grid", type=int, default=None, help="grid side; n = grid^2")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--mu", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the network, object draw, query stream and "
                         "the staged-update stream (stage_random_updates / "
                         "FleetSim), so equal seeds replay identical traffic")
    ap.add_argument("--ops", type=int, default=50_000)
    ap.add_argument("--update-frac", type=float, default=0.05)
    ap.add_argument("--workload", choices=("random", "fleet"), default="random",
                    help="update traffic: random insert/delete churn or the "
                         "moving-fleet stage_move workload")
    ap.add_argument("--fleet-size", type=int, default=96)
    ap.add_argument("--ticks", type=int, default=50,
                    help="fleet workload: serving ticks (one flush per tick)")
    ap.add_argument("--artifact", default=None, help="serve a knn_build --out npz")
    ap.add_argument("--fail-fast", action="store_true",
                    help="die on the first failed flush instead of logging it "
                         "(errors/last_error in the JSON stats) and continuing "
                         "on the last good epoch")
    ap.add_argument("--inject-flush-failure", type=int, default=0, metavar="ROUND",
                    help="make the flush of round ROUND fail just before its "
                         "epoch swap (fault-injection smoke for the "
                         "graceful-degradation path)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--use-kernel", action=argparse.BooleanOptionalAction, default=True,
        help="CUDA kernels (default) or, with --no-use-kernel, their plain versions",
    )
    args = ap.parse_args(argv)

    try:
        family = get_arch(args.arch).family
    except KeyError:
        family = None
    if family == "lm":
        args.batch = 4 if args.batch is None else args.batch
        return serve_lm(args)
    if family == "knn":
        return serve_knn(args)
    raise SystemExit(
        f"serve.py serves an arch of the 'lm' or 'knn' arch family; {args.arch!r} is "
        + (f"of the {family!r} family (its entry point is "
           "python -m repro_torch.examples.retrieval_recsys)" if family
           else "not an arch of this package")
    )


if __name__ == "__main__":
    main()
