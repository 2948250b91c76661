"""Serving driver, dispatched by architecture family.

LM archs (``granite-moe-1b-a400m``, ``llama4-scout-17b-a16e``, ``qwen2.5-3b``,
``internlm2-20b``, ``qwen1.5-110b``): batched prefill, then an autoregressive
decode loop; the prefill's attention is the K6 kernel:

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

``--partition SPEC`` serves from the vertex-sharded engine
(``ShardedQueryEngine``, S logical shards of one padded table on one card)
instead: same results, tables row-partitioned into contiguous vertex ranges.
One spec names the whole layout: shard count, range boundaries, replication
and routing policy (``--shards N`` and ``--replicate SHARD:R|auto:R`` are the
legacy spellings; mixing them with ``--partition`` is an error):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch knn-index \
      --grid 141 --k 20 --partition shards=4,ranges=auto --hot-shard 0 --hot-frac 0.8

``--hot-shard S --hot-frac F`` skews the query stream so F of each batch lands
in shard S's vertex range (read from the live boundaries);
``--hot-flip-round R`` re-aims it at another shard (``--hot-shard2``, default
the opposite one) at round R. ``replicate=auto:R`` watches a sliding
per-shard query histogram and replicates the hottest shard after the warmup
rounds. ``ranges=auto`` watches the same window per vertex as a drift
detector: whenever its balance ratio (the hottest shard's share x S) passes
``--rebalance-ratio`` it proposes traffic-balanced boundaries
(``propose_starts``) and repartitions on the next flush, at most once every
``--rebalance-cooldown`` rounds. The JSON stats report the active plan under
``"partition"`` and the re-split rounds under ``"repartition_rounds"``.

Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead, ``--no-use-kernel`` runs them
on the card. ``--compile-cache DIR`` (``REPRO_COMPILE_CACHE`` is the
fallback) is the kernels' build directory, the counterpart of the JAX
package's persistent XLA cache: a second process over the same directory
builds no kernel library.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import deque

import numpy as np
import torch

from repro_torch import knn
from repro_torch.analysis import sanitize
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


def generate(params, prompts: torch.Tensor, cfg, gen: int, *, device, use_kernel: bool = True,
             temperature: float = 0.0) -> dict:
    """Prefill the prompts (B, S), then ``gen - 1`` decode steps, greedy or
    sampled: one untimed prefill and decode step first (kernel build and
    load, library handles, allocator), then the timed run, its launch
    counts read from 0. Returns the seconds of each half, the launches, the
    prefill's last-position logits (B, V) and the tokens (B, gen)."""
    from repro_torch.models import transformer as tr

    max_len = prompts.shape[1] + gen
    logits, cache = tr.prefill(params, prompts, cfg, max_len, device=device, use_kernel=use_kernel)
    tr.decode_step(params, cache, torch.argmax(logits, dim=-1), cfg)
    del logits, cache
    synchronize(device)

    ops.reset_launches()
    sampler = torch.Generator(device=device).manual_seed(100)
    t0 = time.perf_counter()
    logits, cache = tr.prefill(params, prompts, cfg, max_len, device=device, use_kernel=use_kernel)
    tokens = _next_tokens(logits, temperature, sampler)
    synchronize(device)
    t_prefill = time.perf_counter() - t0
    first, generated = logits, [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tr.decode_step(params, cache, tokens, cfg)
        tokens = _next_tokens(logits, temperature, sampler)
        generated.append(tokens)
    synchronize(device)
    return {"prefill_s": t_prefill, "decode_s": time.perf_counter() - t0,
            "launches": ops.launches(), "prefill_logits": first,
            "tokens": torch.stack(generated, dim=1).cpu().numpy()}


def serve_lm(args) -> dict:
    """Batched prefill + greedy (or sampled) decode loop."""
    from repro_torch.models import transformer as tr

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    params = tr.init_params(cfg, seed=0, device=device)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), device=device,
                            generator=torch.Generator(device=device).manual_seed(1))
    run = generate(params, prompts, cfg, args.gen, device=device, use_kernel=args.use_kernel,
                   temperature=args.temperature)
    t_prefill, t_decode, out = run["prefill_s"], run["decode_s"], run["tokens"]
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"model {cfg.name}: prefill({args.batch}x{args.prompt_len}) "
          f"{t_prefill * 1e3:.1f} ms; decode {args.gen - 1} steps "
          f"{t_decode * 1e3:.1f} ms ({tps:.1f} tok/s)")
    print("generated token ids (first sequence):", out[0].tolist())
    stats = {
        "arch": args.arch, "model": cfg.name, "device": str(device),
        "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "params": cfg.param_count(), "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3, "decode_tok_per_s": tps, "launches": run["launches"],
        "tokens": out.tolist(),
    }
    print(json.dumps({key: val for key, val in stats.items() if key != "tokens"}))
    return stats


def _knn_partition_plan(args):
    """``--partition`` or the legacy ``--shards`` / ``--replicate`` -> one
    ``PartitionPlan`` (None = the scalar engine)."""
    if args.partition:
        if args.shards or args.replicate:
            raise SystemExit(
                "--partition replaces --shards/--replicate: name the whole "
                "layout in one spec, e.g. --partition shards=4,replicate=auto:2")
        try:
            plan = knn.PartitionPlan.parse(args.partition)
        except knn.EngineConfigError as e:
            raise SystemExit(f"--partition: {e}")
        if plan.shards is None:
            raise SystemExit("--partition must name shards=N")
        return plan
    if not args.shards:
        if args.replicate:
            raise SystemExit(
                "--replicate / --partition replication need the sharded "
                "engine (--shards N or --partition shards=N)")
        return None
    rep = _parse_replicate(args.replicate) if args.replicate else None
    replication = None
    if rep is not None:
        replication = rep if rep[0] == "auto" else (rep,)
    return knn.PartitionPlan(shards=args.shards, replication=replication)


def _build_knn_engine(args, bn, objects, k: int, device, plan=None):
    """The scalar or the sharded engine, per the resolved plan (the serving
    loops drive both through the same query/stage/flush surface)."""
    if plan is not None:
        return knn.build_sharded_engine(bn, objects, k, plan=plan, device=device,
                                        use_kernel=args.use_kernel)
    return knn.QueryEngine.build(bn, objects, k, device=device, use_kernel=args.use_kernel)


def serve_knn_fleet(args, g, bn, k: int, batch: int, t_bn: float, device, plan=None) -> dict:
    """Moving-fleet serving loop: fused ``stage_move`` flushes per tick."""
    sim = knn.FleetSim(g, fleet_size=args.fleet_size, seed=args.seed)
    t0 = time.perf_counter()
    engine = _build_knn_engine(args, bn, sim.positions, k, device, plan=plan)
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
        "partition": engine.partition_plan().describe() if plan is not None else None,
        "sim": sim.stats(),
        "engine": engine.stats(),
    }
    print(json.dumps(stats, indent=2))
    return stats


def _parse_replicate(spec: str) -> tuple:
    """``SHARD:R`` -> (shard, R); ``auto:R`` -> ("auto", R)."""
    try:
        shard_s, _, r_s = spec.partition(":")
        r = int(r_s)
        if r < 1:
            raise ValueError
        return ("auto", r) if shard_s == "auto" else (int(shard_s), r)
    except ValueError:
        raise SystemExit(f"--replicate wants SHARD:R or auto:R (R >= 1), got {spec!r}")


def _hot_range(engine, shard: int, n: int) -> tuple[int, int]:
    """The hot shard's vertex range, read from the live routing boundaries
    (under uneven or repartitioned ranges the shards are not equal-width)."""
    starts = engine.routing.starts
    shard = shard % len(starts)
    lo = int(starts[shard])
    hi = int(starts[shard + 1]) if shard + 1 < len(starts) else n
    return (min(lo, n - 1), min(max(hi, lo + 1), n))


def _draw_queries(rng, n: int, batch: int, hot_range, hot_frac: float) -> np.ndarray:
    """A uniform query batch with ``hot_frac`` of it redirected into
    ``hot_range`` (the skewed-city traffic model)."""
    us = rng.integers(0, n, size=batch)
    if hot_frac > 0 and hot_range is not None:
        m = rng.random(batch) < hot_frac
        us[m] = rng.integers(hot_range[0], hot_range[1], size=int(m.sum()))
    return us


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
    """kNN serving loop: batched queries + staged updates on a QueryEngine
    (or, under a partition plan, a ShardedQueryEngine)."""
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
    plan = _knn_partition_plan(args)
    if args.workload == "fleet":
        if args.artifact:
            # the fleet engine's object set must equal the sim's vehicle
            # positions, which a saved artifact cannot know about
            raise SystemExit("--artifact cannot be combined with --workload fleet")
        return serve_knn_fleet(args, g, bn, k, min(batch, 4096), t_bn, device, plan=plan)
    t0 = time.perf_counter()
    if args.artifact:
        # The artifact must come from the same (grid, seed) network: the
        # engine stores tables + objects, the BN-Graph supplies adjacency. A
        # plan reshards it on load (the artifact stores the logical tables,
        # plus any uneven boundaries the writer served under).
        engine = knn.load_engine(
            args.artifact, bn=bn, plan=plan, device=device, use_kernel=args.use_kernel
        )
        if engine.n != g.n or engine.k != k:
            raise SystemExit(
                f"artifact shape (n={engine.n}, k={engine.k}) does not match "
                f"--grid/--k (n={g.n}, k={k})"
            )
    else:
        engine = _build_knn_engine(args, bn, objects, k, device, plan=plan)
    synchronize(device)
    t_build = time.perf_counter() - t0

    if args.hot_frac and plan is None:
        raise SystemExit("--hot-frac needs the sharded engine (--partition shards=N)")
    auto_reps = plan.auto_replicas() if plan is not None else 0
    replicated_shard = None
    if plan is not None and engine.routing.replication:
        # an explicit plan's replication was applied at build / load time
        replicated_shard = min(engine.routing.replication)
    hot_range = None
    if plan is not None and args.hot_frac:
        hot_range = _hot_range(engine, args.hot_shard, g.n)
    # sliding query histograms: per-shard owner counts pick the hot shard for
    # replicate=auto; the per-vertex window feeds the ranges=auto drift
    # detector, which re-splits whenever the window's balance ratio (the
    # hottest shard's share x S, 1.0 = balanced) passes --rebalance-ratio, at
    # most once every --rebalance-cooldown rounds
    hist: deque = deque(maxlen=16)
    auto_ranges = plan is not None and plan.ranges == "auto" and engine.num_shards > 1
    vwin: deque = deque(maxlen=args.rebalance_window)
    repartition_rounds: list[int] = []
    balance_ratio = None

    rng = np.random.default_rng(args.seed + 1)
    mset = set(engine.objects.tolist())
    n_upd_round = int(round(batch * args.update_frac))
    rounds = max(1, args.ops // (batch + n_upd_round))

    # warmup: the first gather outside the timed loop
    engine.query_batch(_draw_queries(rng, g.n, batch, hot_range, args.hot_frac))
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
        if args.hot_flip_round and rnd + 1 == args.hot_flip_round:
            # the hot city moves: re-aim the skewed traffic at another shard's
            # range (read from the CURRENT boundaries)
            flip_to = (
                args.hot_shard2
                if args.hot_shard2 is not None
                else (args.hot_shard + engine.num_shards // 2) % engine.num_shards
            )
            hot_range = _hot_range(engine, flip_to, g.n)
        us = _draw_queries(rng, g.n, batch, hot_range, args.hot_frac)
        t0 = time.perf_counter()
        engine.query_batch(us)
        synchronize(device)
        t_query += time.perf_counter() - t0
        queries += batch

        if auto_ranges:
            vwin.append(np.bincount(us, minlength=g.n))
            wsum = np.sum(vwin, axis=0)
            starts = engine.routing.starts
            shares = np.add.reduceat(wsum, starts)
            balance_ratio = float(shares.max() * engine.num_shards / max(wsum.sum(), 1))
            cooled = (not repartition_rounds
                      or rnd + 1 - repartition_rounds[-1] >= args.rebalance_cooldown)
            if rnd + 1 >= 3 and cooled and balance_ratio > args.rebalance_ratio:
                proposed = knn.propose_starts(wsum, engine.num_shards)
                if not np.array_equal(proposed, starts):
                    engine.repartition(proposed)  # rides a fresh epoch; old
                    repartition_rounds.append(rnd + 1)  # epochs keep theirs
                    hist.clear()  # owner counts now follow the new boundaries

        if auto_reps and replicated_shard is None:
            hist.append(np.bincount(engine.routing.owner(us), minlength=engine.num_shards))
            warmup = 3 if not auto_ranges else 6  # let the ranges settle first
            if rnd + 1 >= warmup and hist:
                hot = int(np.argmax(np.sum(hist, axis=0)))
                engine.set_replication({hot: auto_reps}, policy=plan.policy)
                replicated_shard = hot

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
        "replicate": args.replicate,
        "replicated_shard": replicated_shard,
        "partition": engine.partition_plan().describe() if plan is not None else None,
        "repartitioned_at_round": repartition_rounds[0] if repartition_rounds else None,
        "repartition_rounds": repartition_rounds,
        "balance_ratio": round(balance_ratio, 4) if balance_ratio else None,
        "hot_frac": args.hot_frac,
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
    ap.add_argument("--partition", default=None, metavar="SPEC",
                    help="the whole partition layout as one spec, e.g. "
                         "'shards=4,replicate=auto:2,ranges=auto' (keys: shards, "
                         "ranges [equal | auto | 0:B1:B2...], replicate [SHARD:R | "
                         "auto:R], policy); serves from the sharded engine, S "
                         "logical shards on one card. ranges=auto repartitions on "
                         "flush from the sliding query histogram")
    ap.add_argument("--shards", type=int, default=0,
                    help="[legacy: use --partition shards=N] serve from the "
                         "sharded engine with this many shards (0 = scalar engine)")
    ap.add_argument("--replicate", default=None, metavar="SHARD:R",
                    help="[legacy: use --partition replicate=...] replicate shard "
                         "SHARD's blocks into R extra buffers and fan its queries "
                         "across them; 'auto:R' picks the hottest shard from a "
                         "sliding query histogram after a short warmup")
    ap.add_argument("--hot-shard", type=int, default=0,
                    help="sharded: which shard --hot-frac concentrates queries into")
    ap.add_argument("--hot-frac", type=float, default=0.0,
                    help="sharded: fraction of each query batch drawn from the hot "
                         "shard's vertex range (0 = uniform)")
    ap.add_argument("--hot-flip-round", type=int, default=0, metavar="ROUND",
                    help="sharded: at round ROUND re-aim --hot-frac traffic at "
                         "another shard's range (the ranges=auto drift detector's "
                         "second re-split)")
    ap.add_argument("--hot-shard2", type=int, default=None,
                    help="sharded: the shard --hot-flip-round re-aims traffic at "
                         "(default: the shard opposite --hot-shard)")
    ap.add_argument("--rebalance-ratio", type=float, default=1.25,
                    help="ranges=auto: re-split when the sliding window's balance "
                         "ratio (hottest shard share x S, 1.0 = balanced) exceeds this")
    ap.add_argument("--rebalance-window", type=int, default=16,
                    help="ranges=auto: rounds of per-vertex query history the drift "
                         "detector slides over")
    ap.add_argument("--rebalance-cooldown", type=int, default=4,
                    help="ranges=auto: minimum rounds between re-splits")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="kernel build directory (REPRO_COMPILE_CACHE env var is the "
                         "fallback); a second process over the same dir builds nothing")
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--use-kernel", action=argparse.BooleanOptionalAction, default=True,
        help="CUDA kernels (default) or, with --no-use-kernel, their plain versions",
    )
    args = ap.parse_args(argv)

    # before anything builds: the libraries are looked up in, and built into,
    # the directory named here
    sanitize.enable_compile_cache(args.compile_cache)

    try:
        family = get_arch(args.arch).family
    except KeyError:
        family = None
    if family == "lm":
        args.batch = 4 if args.batch is None else args.batch
        return serve_lm(args)
    if family == "knn":
        return serve_knn(args)
    entry = {"recsys": "python -m repro_torch.examples.retrieval_recsys",
             "gnn": "python -m repro_torch.launch.train"}
    raise SystemExit(
        f"serve.py serves an arch of the 'lm' or 'knn' arch family; {args.arch!r} is "
        + (f"of the {family!r} family (its entry point is {entry[family]})" if family
           else "not an arch of this package")
    )


if __name__ == "__main__":
    main()
