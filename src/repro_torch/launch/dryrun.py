"""One-card dry run: count the work of every (arch x shape) cell's step at its
published shapes, without running it. The port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]

needs no card: parameters, optimizer state and inputs are made on ``meta``
(shapes without values, as the JAX dry run lowers against abstract arrays
on fake devices), and the step runs once under ``op_cost.count()``, which
counts every aten op and each kernel entry as one op, and never runs a
kernel. It writes one JSON record a cell, ``<arch>__<shape>__1xH100[__tag].json``,
and prints one ``OK`` / ``SKIP`` / ``FAIL`` line a cell; any ``FAIL`` exits
non-zero.

The record keeps the JAX record's keys that ``benchmarks/roofline.py`` reads:
``arch``, ``shape``, ``kind``, ``variant``, ``tag``, ``mesh`` (``"1xH100"``),
``n_chips`` (1), ``per_device.{flops, hbm_bytes, collective_bytes}`` (the
last 0), ``roofline_terms_s`` (``op_cost.Count.roofline_terms_s``: the H100's
data-sheet rates) and ``bottleneck``. It adds ``flops_by_dtype``, ``ops``,
``kernels`` (each entry's calls, flops and bytes) and ``memory``
(``argument_bytes``, ``output_bytes``, ``state_bytes``: parameters plus
optimizer state). ``trace_s`` (building and counting the step) takes the
place of ``lower_s`` and ``compile_s``. Dropped: ``collectives`` (no
collective on one card), ``loops`` (a Python loop needs no trip-count
correction) and ``raw_cost_analysis`` (XLA's own count, which has no torch
counterpart); ``memory`` keeps none of XLA's ``memory_analysis`` fields.

``build_cell`` makes a cell's step and arguments on any device: on ``meta``
empty tensors, elsewhere inputs drawn from ``seed`` (``chip_smoke.py`` runs
cells on the card through it).

Variant knobs (``--variant k=v,...``): ``gnn_bf16``, ``knn_contig`` and
``capacity_factor`` act as in the JAX package. ``NO_COUNTERPART`` lists the
JAX knobs that tile, rematerialise, shard or donate on a mesh; each raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.common import GNN_SHAPE_META
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.device import generator, resolve_device
from repro_torch.launch import op_cost
from repro_torch.models import recsys as rec
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves

MESH = "1xH100"

NO_COUNTERPART = {
    "attn_probs_bf16": "XLA attention-probability precision; K6 keeps its own",
    "remat_policy": "XLA rematerialisation policy",
    "q_chunk": "XLA attention tiling; K6 picks its own tiles",
    "kv_chunk": "XLA attention tiling; K6 picks its own tiles",
    "node_shard": "places GNN nodes on mesh axes",
    "knn_bf16": "K1 takes float32 and float16 distances only",
    "knn_donate": "buffer donation; the port's build step writes its tables in place",
    "knn_vk_sharded": "shards the tables over a mesh",
    "decode_donate": "buffer donation; the port's decode writes its cache in place",
    "serve_fsdp": "shards the serving parameters over a mesh",
    "cache_layout": "shards the KV cache over a mesh",
}
SUPPORTED = ("gnn_bf16", "knn_contig", "capacity_factor")


def check_variant(variant: dict) -> None:
    for knob in variant:
        if knob in NO_COUNTERPART:
            raise ValueError(f"variant knob {knob!r} has no one-card counterpart "
                             f"({NO_COUNTERPART[knob]})")
        if knob not in SUPPORTED:
            raise ValueError(f"unknown variant knob {knob!r}; the port takes {SUPPORTED}")


def _config(arch, shape_name: str, variant: dict):
    if arch.family == "gnn":
        cfg = arch.make_config(shape_name)
        if variant.get("gnn_bf16"):
            cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        return cfg
    cfg = arch.make_config()
    if arch.family == "lm" and variant.get("capacity_factor"):
        cfg = dataclasses.replace(cfg, capacity_factor=float(variant["capacity_factor"]))
    return cfg


def _draw(arch, cfg, shape_name: str, specs: dict, name: str, gen, dev) -> torch.Tensor:
    """Input ``name`` of the cell drawn from ``gen``, its ids in their range."""
    shape, dtype = specs[name]
    if dtype.is_floating_point:
        x = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        if arch.family == "knn":
            x = x * 100.0
            if name == "vk_d":
                x[cfg.n_vertices:] = float("inf")  # the pad rows
        return x.to(dtype)
    ints = lambda hi, lo=0: torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)
    if arch.family == "lm":
        return ints(cfg.vocab)
    if arch.family == "recsys":
        return ints(2) if name == "labels" else ints(cfg.table_rows)
    if arch.family == "knn":
        n = cfg.n_vertices
        if name == "verts":  # distinct rows: each written once
            return torch.randperm(n, generator=gen, device=dev)[: shape[0]].to(dtype)
        if name == "queries":
            return ints(n)
        x = ints(n, -1)
        if name == "vk_ids":
            x[n:] = -1
        return x
    n_nodes = specs["pos"][0][0]
    if name == "edge_index":
        return ints(n_nodes)
    if name == "graph_id":  # graphs of equal size, in order
        graphs = specs["graph_targets"][0][0]
        return (torch.arange(n_nodes, device=dev) * graphs // n_nodes).to(dtype)
    if name == "species":
        return ints(cfg.n_species)
    return ints(GNN_SHAPE_META[shape_name]["n_classes"])  # node labels


def _inputs(arch, cfg, shape_name: str, specs: dict, dev: torch.device, seed: int) -> dict:
    """The cell's array inputs on ``dev``: empty on ``meta``, else drawn."""
    gen = generator(dev, seed)
    out = {}
    for name, spec in specs.items():
        if not isinstance(spec, tuple):
            continue  # a plain size
        shape, dtype = spec
        if dev.type == "meta":
            out[name] = torch.empty(shape, dtype=dtype, device=dev)
        else:
            out[name] = _draw(arch, cfg, shape_name, specs, name, gen, dev)
    return out


def build_cell(arch, shape_name: str, cell, variant: dict | None = None, *,
               device="meta", seed: int = 0, use_kernel: bool = True):
    """The cell's step and its arguments on ``device``: ``(fn, args,
    n_state)``, ``fn(*args)`` one step, its first ``n_state`` arguments the
    parameters (and optimizer state)."""
    variant = variant or {}
    check_variant(variant)
    dev = resolve_device(device)
    cfg = _config(arch, shape_name, variant)
    specs = cell.specs(cfg)
    x = _inputs(arch, cfg, shape_name, specs, dev, seed)

    if arch.family == "lm":
        params = tr.init_params(cfg, seed=seed, device=dev)
        if cell.kind == "train":
            fn = steps.make_lm_train(cfg, device=dev, use_kernel=use_kernel)
            return fn, (params, adamw.init(params), x), 2
        if cell.kind == "prefill":
            fn = steps.make_lm_prefill(cfg, specs["max_len"], device=dev, use_kernel=use_kernel)
            return fn, (params, x["tokens"]), 1
        if cell.kind == "decode":
            fn = steps.make_lm_decode(cfg, specs["cache_batch"], specs["cache_len"], device=dev)
            cache = tr.init_cache(cfg, specs["cache_batch"], specs["cache_len"], device=dev)
            return fn, (params, cache, x["tokens"]), 1

    if arch.family == "gnn":
        mod = steps.GNN_MODULES[arch.arch_id]
        params = mod.init_params(cfg, seed=seed, device=dev)
        fn = steps.make_gnn_train(arch.arch_id, cfg, device=dev)
        return fn, (params, adamw.init(params), x), 2

    if arch.family == "recsys":
        params = rec.init_params(cfg, seed=seed, device=dev)
        if cell.kind == "train":
            return steps.make_recsys_train(cfg, device=dev), (params, adamw.init(params), x), 2
        if cell.kind == "forward":
            return steps.make_recsys_forward(cfg, device=dev), (params, x), 1
        if cell.kind == "retrieval":
            fn = steps.make_recsys_retrieval(cfg, specs["n_candidates"], device=dev,
                                             use_kernel=use_kernel)
            return fn, (params, {"sparse_ids": x["sparse_ids"]}), 1

    if arch.family == "knn":
        if cell.kind == "knn_build":
            contig = bool(variant.get("knn_contig"))
            fn = steps.make_knn_build(cfg, contiguous=contig, device=dev, use_kernel=use_kernel)
            args = tuple(x[k] for k in ("verts", "nbr", "w", "extra_ids", "extra_d",
                                        "vk_ids", "vk_d"))
            return fn, ((0,) + args[1:]) if contig else args, 0
        if cell.kind == "knn_serve":
            fn = steps.make_knn_serve(cfg, device=dev)
            return fn, tuple(x[k] for k in ("vk_ids", "vk_d", "queries")), 0

    raise ValueError(f"unhandled cell {arch.arch_id}/{shape_name} kind={cell.kind}")


def tensors_of(tree) -> list[torch.Tensor]:
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def count_step(fn, args) -> tuple[op_cost.Count, object]:
    """One step under the count: (the count, the step's outputs)."""
    with op_cost.count() as c:
        out = fn(*args)
    return c, out


def record(arch, shape_name: str, cell, variant: dict, tag: str, c: op_cost.Count,
           args, n_state: int, out, trace_s: float) -> dict:
    terms = c.roofline_terms_s()
    return {
        "arch": arch.arch_id,
        "shape": shape_name,
        "kind": cell.kind,
        "variant": variant,
        "tag": tag,
        "mesh": MESH,
        "n_chips": 1,
        "trace_s": round(trace_s, 2),
        "per_device": {"flops": c.flops, "hbm_bytes": c.bytes, "collective_bytes": 0},
        "flops_by_dtype": dict(c.flops_by_dtype),
        "ops": c.ops,
        "kernels": c.kernels,
        "memory": {
            "argument_bytes": op_cost.nbytes(tensors_of(args)),
            "output_bytes": op_cost.nbytes(tensors_of(out)),
            "state_bytes": op_cost.nbytes(tensors_of(args[:n_state])),
        },
        "roofline_terms_s": terms,
        "bottleneck": max(terms, key=terms.get),
    }


def run_cell(arch, shape_name: str, cell, *, out_dir: Path, variant: dict | None = None,
             tag: str = "") -> dict:
    """Count the cell's step on ``meta`` and write its record."""
    variant = variant or {}
    t0 = time.perf_counter()
    fn, args, n_state = build_cell(arch, shape_name, cell, variant, device="meta")
    c, out = count_step(fn, args)
    rec_ = record(arch, shape_name, cell, variant, tag, c, args, n_state, out,
                  time.perf_counter() - t0)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{arch.arch_id}__{shape_name}__{MESH}"
    if tag:
        fname += f"__{tag}"
    (out_dir / f"{fname.replace('/', '_')}.json").write_text(json.dumps(rec_, indent=2))
    return rec_


def main() -> None:
    ap = argparse.ArgumentParser(description="count every cell's step on meta, one card")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--include-skipped", action="store_true")
    ap.add_argument("--variant", default="", help="k=v,... variant knobs")
    ap.add_argument("--tag", default="", help="artifact suffix for variant runs")
    args = ap.parse_args()
    variant = dict(kv.split("=", 1) for kv in args.variant.split(",") if kv)

    out_dir = Path(args.out)
    if args.all:
        cells = all_cells(include_skipped=args.include_skipped)
    else:
        arch = get_arch(args.arch)
        cells = [(arch, shape, cell) for shape, cell in arch.shapes.items()
                 if not args.shape or shape == args.shape]

    failures = 0
    for arch, shape, cell in cells:
        if cell.skip and not args.include_skipped and args.shape != shape:
            print(f"SKIP  {arch.arch_id:<24} {shape:<14} ({cell.skip})")
            continue
        tag = f"{arch.arch_id}/{shape} mesh={MESH}"
        if args.tag:
            tag += f" [{args.tag}]"
        try:
            r = run_cell(arch, shape, cell, out_dir=out_dir, variant=variant, tag=args.tag)
            t = r["roofline_terms_s"]
            print(f"OK    {tag:<52} trace={r['trace_s']:>7.1f}s "
                  f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
                  f"coll={t['collective_s']:.3e}s -> {r['bottleneck']}", flush=True)
        except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the rest run
            failures += 1
            print(f"FAIL  {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
