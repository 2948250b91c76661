#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port starts and is right.

    python3 chip_smoke.py              # needs one NVIDIA GPU (Hopper) and nvcc

What it does, in order (any failure exits non-zero; there is no CPU path):

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the six CUDA sources from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all at once;
3. holds each kernel against its plain PyTorch version on the card, exact
   equality, at the full-width shapes of the ``knn-index-usa`` configuration
   (2^24-vertex tables, level batch 131072, tau 32, k 20), and times both;
   then once more at the shapes the flushes below give them (hundreds of
   source columns, hundreds of candidates or neighbours per row); K2 as a
   tile (its repair-round form), in place as one level of its one-launch
   sweep, and as one launch for a whole synthetic sweep of 200 levels
   (1-20,000 rows, 1-200 neighbours) at n = 2^24, against the plain version
   level by level; K1 also at both sides of each of its register
   boundaries (C = 128/129, 256/257, 512/513, 768/769), at C = 4,000 and
   30,000 (past what its first design's shared memory held), and timed at
   the flush's wide shape C = k + 512; K3 through both of its entries (the
   JAX package's signature and the engine's fused ``frontier_relax_rows``,
   tile and changed mask) at B = 1, 2, 64, 475, 476 and T = 8, 32, 128, 200,
   with 1,000 receivers too (a warp a (row, column chunk)), the receivers'
   rows of the matrix unchanged after the kernels;
   ``minplus`` at 4096^3, at a shape whose edges are not multiples of its
   tile, with +inf rows and columns and one NaN, on block-sparse operands
   whose all-+inf slices face a -inf or a NaN (its pair count held to the
   plain slice bits' count), and in float16 / bfloat16; ``cuobjdump`` reads
   K2's and K4's registers, spills and LDGSTS counts;
4. ``certify``: the BN-Graph certificate of a 141 x 141 road network
   (n = 19,881, the largest grid under ``knn_build``'s n <= 20,000 gate)
   with the ``minplus`` kernel, its launch count set to 0 just before and
   read just after; the kernel's square against the plain version's on 512
   sampled rows, its walked (tile, t slice) pairs against the plain slice
   bits' count, its time beside the dense floor and the input's own bound,
   ``certificate(..., use_kernel=False)`` giving the same dict, and a
   corrupted edge weight failing the relaxation check;
5. ``cli``: the command-line entry points in subprocesses at grid 141:
   ``knn_build --verify --out`` (tables verified, BN-Graph certified with the
   kernel), ``serve --artifact`` under random traffic with one injected flush
   failure, and ``serve --workload fleet`` (200 vehicles, 1% of vertices,
   all moving every tick);
6. drives the main path through the public entry points at a real road-network
   size: ``road_network`` -> ``build_bngraph`` -> ``knn.build_engine`` ->
   ``query_batch`` -> three ``flush_updates`` of mixed insert/delete/move
   traffic, checking the tables against a plain-version build, a Dijkstra
   sample, a direct table read and a rebuild on the final object set, with
   the kernels' launch counts set to 0 just before and read just after (the
   build must be one K2 launch a sweep). A twin engine that runs only the
   plain versions takes the same traffic, and after every flush the two
   engines' tables must be equal bit for bit. Each sweep is timed alone, and
   a fourth flush runs under ``torch.profiler`` (and CUDA events around each
   kernel call) for K1-K3's own device time at the flush's shapes, with each
   K1 and K3 call's shape and its bound there;
7. ``durability`` on the main path's engine: ``save`` -> ``load_engine``
   (tables equal), a journaled flush, a second batch killed mid-repair,
   recovery from the artifact plus the journal, held equal to an uncrashed
   engine loaded from the same artifact that took the same ops;
8. ``sharded``: the vertex-sharded engine (S logical shards of one padded
   table on the card) on the main path's BN-Graph and initial objects, held
   to a scalar engine built there: S = 4 equal and ``ranges=auto`` builds
   (tables equal), a 2^20-query batch routed across the shards (answers
   equal; queries/s beside the scalar engine's), three flushes of the main
   path's traffic with the collective halo and one (a fifth of it) with the
   host halo (flush stats and tables equal after each; seconds,
   ``halo_rounds_collective`` and ``halo_fallbacks`` a flush), a repartition
   flush under a skewed query histogram with a read pinned to the epoch
   before it, the hottest shard replicated twice under both policies
   (answers equal, every replica buffer byte-identical to its primary's
   block), save at S = 4 and load at S = 1, 2 and 8 with a flush each; the
   launches of the sharded engines' own calls, the counts set to 0 just
   before each call and read just after (the scalar comparand's are not): K2's sweep in each sharded build, K1 in
   every flush at S > 1, K3 and K2's repair rounds in the flush at S = 1;
   then ``serve --partition shards=4,ranges=auto
   --hot-shard 0 --hot-frac 0.8`` in a subprocess at grid 141;
9. ``sanitize``: the runtime rail on the card, on the sharded phase's
   engines: a sync planted under ``no_transfers`` must raise
   ``SanitizerError``; with ``REPRO_SANITIZE=1``, a 2^20-query batch and a
   flush of the main path's traffic through the grid-384 scalar engine, and
   a collective flush through the S = 4 engine, each beside a plain-version
   twin made from its tables: nothing raises, every post-flush table scan
   runs and passes, tables ``torch.equal`` to the twin's, with each call's
   ``h2d`` / ``d2h`` counts; ``check_kernel_aliasing`` (K2 tile and levels,
   K3 both entries, K1 in place, poisoned inputs, exact); this process's
   first build held to the cold build budgets and a second process over the
   same build directory to the warm ones (0 libraries built);
10. ``check_retrieval_topk``: K5 against its plain version, exact (ids,
   scores and the sign of zero), one launch a call, first where its one-launch
   design could go wrong: back-to-back calls on the same and on other inputs
   (the arrival counters reset), ascending, descending and all-equal rows,
   NaN, +inf (fewer and more than k) and -0.0, N = 1,000,003 in float32 and
   bfloat16 and a storage offset of 1 (rows not 16-byte aligned), a row whose
   k best lie in one part and one whose k-th key ends a part, k = 1024 at
   (1, 10^6), B = 70,000, the plan's largest P; then at the JAX kernel
   test's shapes, with heavy ties, -inf rows, N < k, bfloat16, at
   (512, 10^6) and at the ``retrieval_cand`` shape (1, 10^6, k = 100); times
   it (and its host enqueue) beside ``torch.topk`` at (1, 10^6) and
   (512, 10^6), on ascending scores and at k = 1024;
11. ``recsys``: the full ``xdeepfm`` configuration on the card (1.56 GB of
   tables from a seeded generator): ``forward`` at the serve_p99 (512) and
   serve_bulk (262,144) batches, held to a float64 evaluation and to each
   other; ``retrieval_score`` over 10^6 candidates with K5 (launch count set
   to 0 just before and read just after: one launch), equal to the plain
   version's, with one call profiled (device time by kernel, CUDA events
   around its gathers, product and K5); and the retrieval example in a
   subprocess (two launches for its two kernel calls);
12. ``check_flash_attention``: K6 against its plain version within stated
   tolerances (bf16 also within a per-element bound of its route) on both of
   its routes (bf16 at D = 128: ``wgmma`` + TMA; float32, and bf16 at
   D < 128: FMAs on the CUDA cores), at (1, 32768, 16/2, 128) causal bf16, at
   the prefill shape (4, 2048, 16/2, 128) causal in bf16 and float32, in
   bf16 at lengths no 128-row tile divides, T > S and S > T, H = Hkv, a
   two-block grid, no kv rows and one query row, and at every other head dim
   (8, 16, 32, 64) in both dtypes; times both routes and, beside them,
   ``scaled_dot_product_attention(enable_gqa=True)`` (bf16 at 2,048 and
   32,768; D = 64 bf16 and D = 32 float32 at (4, 2048, 16/2)); then at the
   newer LMs' prefill head layouts in bf16, each timed beside SDPA and its
   plain version: (4, 2048, 16/8, 64) (granite-moe, FMA route) and (4, 2048,
   40/8 | 48/8 | 64/8, 128) (llama4-scout, internlm2-20b, qwen1.5-110b:
   ``wgmma`` at GQA groups of 5, 6 and 8); reads the bf16
   kernel's registers and its HGMMA / UTMALDG count with ``cuobjdump``;
13. ``lm``: ``serve --arch qwen2.5-3b --batch 4 --prompt-len 2048 --gen 32``
   in a subprocess (full width, full depth, bf16: 36 K6 launches in its
   prefill, counted by serve.py from 0 just before its timed run), then in
   process two full-width, two-layer twins, float32 and bf16, whose prefill
   runs once with K6 and once with the plain attention: logits within the
   stated ``LOGIT_TOL``, and the same greedy tokens over 16 decode steps
   (a row may part only at a near-tie);
14. ``lm_archs``: ``serve --arch granite-moe-1b-a400m`` and ``serve --arch
   internlm2-20b`` (batch 4, prompt 2048, 32 tokens, full width and depth,
   bf16) in subprocesses, their parameters ``param_count()`` and one K6
   launch a layer in the prefill (24 and 48); granite's prefill once more in
   process with CUDA events around each K6 call and each MoE FFN (their
   share of the prefill); llama4-scout-17b-a16e and qwen1.5-110b, which do
   not fit the card whole, at full width and ``REDUCED_DEPTH`` (8 of 48 and
   12 of 80 layers) through ``serve.generate``; granite's two-layer twins
   (float32, bf16) as ``lm``'s; and one full-width granite MoE layer over
   8,192 tokens on the card against the CPU (routing equal but at near-ties,
   ``ROUTE_GAP``; the card's routing through dispatch, experts and combine on
   both sides within ``MOE_TOL``; bit-equal repeats; clean under the sync
   guard);
15. ``train``: the full qwen2.5-3b (36 layers, bf16) takes ``TRAIN_STEPS``
   ``make_lm_train`` steps at batch 1 x 2,048 ``MarkovLMStream`` tokens
   (AdamW, float32 moments; K6 counted from 0 around the steps: one launch a
   layer a step; step time, tokens/s, peak memory); a two-layer full-width
   float32 twin takes one step with K6 and one with the plain attention
   (loss, grad_norm and every gradient leaf within the stated ``TWIN_*``
   tolerances); the full granite-moe-1b-a400m (24 layers, bf16) takes
   ``TRAIN_STEPS`` steps likewise (24 K6 launches a step), then one
   checkpoint of its (params, opt_state) (~13.9 GB, bare expert leaves, a
   float32 router) is saved by ``launch/train.py``'s own stacking and
   restored row by row, timed, every leaf equal; the full xdeepfm takes
   ``RECSYS_TRAIN_STEPS`` steps at the
   training batch of ``launch/train.py`` (65,536), then one checkpoint of (params, opt_state) is
   saved and restored, timed, every leaf equal; then in subprocesses
   ``launch.train --smoke`` for 6 steps and again for 8 (``resumed from step
   6``), with ``--arch qwen2.5-3b`` and ``--arch granite-moe-1b-a400m``, the
   ``train_lm`` example (lm-15m, 150 steps, K6 at D = 32, the loss
   down by at least 0.5) and the two kNN example twins (``quickstart``,
   ``knn_road_service``) at their default sizes;
16. ``gnn``: the GNN family, on whose path no kernel lies (the reference
   runs it on ``segment_sum`` and ``einsum``; every launch count must stay 0
   through the in-process part): gcn-cora at ``full_graph_sm`` (Cora's
   2,708 nodes, 1,433 features) and egnn, nequip and mace at ``molecule``
   (128 graphs of 30 nodes, 64 edges) at their published widths, the card's
   loss and every gradient leaf held to a float32 CPU run of the same
   parameters and batch (``GNN_LOSS_RTOL``, ``GNN_GRAD_TOL``; non-finite
   entries, egnn's zero-length edges, at the same places), then
   ``TRAIN_STEPS`` AdamW steps each (step ms, peak GB); nequip's and mace's
   energies under a rotation and shift (``GNN_EQUIV_RTOL``); gcn-cora at
   ``ogb_products`` (2,449,029 nodes, 61,859,140 edges) for
   ``GNN_BIG_STEPS`` steps, its loss held to the same forward in float64;
   ``sample_khop`` (1,024 seeds, fanout 15-10) and ``pad_subgraph`` at
   ``minibatch_lg`` on a 483 x 483 road network with ``GNN_BIG_STEPS``
   steps of its config; then ``launch.train`` in subprocesses: each GNN
   with ``--smoke``, nequip on the full molecule stream, mace resumed from
   step 6; the phase's seconds;
17. ``cells``: the cell catalogue. ``python -m repro_torch.launch.dryrun
   --all`` in a subprocess (beside the card work: it counts on ``meta``)
   must print 37 ``OK`` lines and write 37 records, each with flops > 0 but
   the two knn-index cells'; each record's flops, bytes, roofline terms and
   bottleneck are printed. Then the cells whose steps the dry run's
   factories added run on the card through ``dryrun.build_cell``, each
   once warm (under ``op_cost.count()``: its flops and bytes must equal the
   same cell's count on ``meta``) and once timed with CUDA events, beside
   the count's roofline terms and the share max(terms) / measured:
   knn-index ``build_sweep`` at full shape (K1 counted from 0 around the
   call: one launch; tables ``torch.equal`` to the plain step's; the
   ``knn_contig`` form equal to the scatter form on contiguous rows),
   ``serve_batch`` (2^20 queries, equal to a direct row read), xdeepfm
   ``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` (one K5 launch, ids
   and scores equal to the plain step's), qwen2.5-3b ``prefill_32k`` and
   ``decode_32k`` at full width and depth with their batches cut to fit the
   card (``CELL_CUTS``; 36 K6 launches in the prefill, finite logits, then
   ``TRAIN_STEPS`` decode steps); the phase's seconds;
18. prints one ``{"kernels": [...]}`` line (each entry says which phase its
   launch count covers) and, last, ``{"ok": true, "device": {...}}``.

Bounds: ``bound_ms`` is the larger of (bytes the function must move: every
input byte it needs once, every output byte once) / 3.35 TB/s and (operations)
/ 67 TFLOP/s (H100 SXM data-sheet rates, float32 outside the tensor cores;
989 TFLOP/s for the bfloat16 attention, which the tensor cores could do;
``repro_torch/launch/op_cost.py`` names them),
computed from this run's inputs (distinct gathered rows, valid neighbour
slots, unmasked query-key pairs).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# the H100 SXM's data-sheet rates, named once for the port
from repro_torch.launch.op_cost import (  # noqa: E402
    BF16_OPS_PER_S as BF16_TENSOR_OPS_PER_S,
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
)

# FP32 lanes of an H100 SXM: 132 SMs x 128
SM_LANES = 132 * 128
# K6 against its plain version: |kernel - plain| <= atol + rtol * |plain|.
# float32: the two sum p*v and p in another order. bfloat16: the output is rounded to bfloat16 on each side, one ulp
# of which is 2^-8 relative, and p is rounded before the PV product.
ATTN_TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-2, 2e-2)}
# Each bf16 route is held to a per-element bound of its own as well. The
# (2e-2, 2e-2) above is as large as a typical output (an output's spread is
# about sqrt(e / keys): 0.036 at 2,048 keys, ~0.01 at 32,768), so a kernel that
# skipped one kv tile or read one stale stage (a row off by ~1/n_kv of its
# mass) would pass it. 1.6e-2 |plain| is two ulps wherever |plain| lies in its
# binade. wgmma (bf16 at D = 128): 1e-3 for outputs near 0, where the rounding
# of p to bf16 (2^-9 of each term, on the two sides apart) decides. fma (bf16
# at D < 128; measured before ATTN_KV_TILE below): the kernel rounds p against
# a running max over 64-column kv tiles, the plain version against one over
# 1,024-column blocks, so in a row
# whose max moves after its first kv tile the two round p at different
# scales, and an output near 0 parts by more (NVIDIA H100 80GB HBM3, D = 8:
# 1.07 times the wgmma bound at (2, 300, 8/2) causal, ~1.1e-3 near 0). Its
# absolute term is 2.5e-3, still under the 4e-3 that a skipped kv tile moves
# an output of ~0.03 by at 2,048 keys. tools/k6_planted_faults.py shows a
# dropped or stale kv tile of either kernel failing its route's bound.
ATTN_ULPS_BF16 = {"wgmma": (1e-3, 1.6e-2), "fma": (2.5e-3, 1.6e-2)}
# the plain version K6 is held to computes with the route's own kv tile
# (``ref.flash_attention_ref(kv_block=)``), so that in bf16 both round each
# p against the same running max: 128 on wgmma, 64 on the FMA route. Against
# the plain version's default 1,024-row blocks the two round p at different
# scales, and with more outputs that rounding alone passed the per-element
# bound (NVIDIA H100 80GB HBM3: 1.98 times the wgmma bound at (4, 2048, 64/8,
# 128) causal, 6 of 67 million outputs) while K6 stayed as close to a float64
# attention as the plain version (mean |error| 1.144e-4 against 1.158e-4).
ATTN_KV_TILE = {"wgmma": 128, "fma": 64}
# the two-layer twins' last-position logits (unit scale, |logit| up to ~5),
# kernel against plain attention: |kernel - plain| <= atol + rtol * |plain|.
# float32: two layers of products summed in another order. bfloat16: the two
# attentions round an output to different bf16 neighbours here and there, and
# every later layer rounds to bf16 again, so the residual stream parts by a
# few ulps and a logit, a 2,048-term sum of it, by an amount that does not
# scale with the logit (0.047 on a logit near 0.5 on an H100, exactly what
# scaled_dot_product_attention in its place parts by): the bound is absolute,
# 0.125 (8 ulps at 1-2, 2 at 4-8). The twin also prefills with
# scaled_dot_product_attention, to show the spread between two correct
# attentions beside it; tools/k6_planted_faults.py reads it with a broken K6.
LOGIT_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (0.125, 0.0)}
# a near-tie in the greedy comparison: the top two plain logits within
# atol + rtol * |top|. For bfloat16 it scales with the top logit, a few of
# its ulps, and not the absolute 0.125 of LOGIT_TOL.
TIE_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 3e-2)}
# (H, Hkv, D) of the newer LMs, whose prefill runs K6 there
HEAD_LAYOUTS = {"granite-moe-1b-a400m": (16, 8, 64), "llama4-scout-17b-a16e": (40, 8, 128),
                "internlm2-20b": (48, 8, 128), "qwen1.5-110b": (64, 8, 128)}
# llama4-scout (1.02e11 parameters, 204 GB in bf16) and qwen1.5-110b (1.11e11,
# 222 GB) do not fit one 80 GB card whole: they run at full width with their
# depth cut to ~37-38 GB of weights, room left for the prefill's activations.
# Their layers are all alike, so the cut keeps the layer pattern whole.
REDUCED_DEPTH = {"llama4-scout-17b-a16e": 8, "qwen1.5-110b": 12}
# MoE on the card against the CPU: one full-width granite layer over
# MOE_TOKENS float32 tokens. The router's logits are 1,024-term float32 sums,
# which cuBLAS and the CPU's BLAS add in other orders (parting by ~1e-6 of a
# logit, less in a probability), so a token may pick other experts than on
# the CPU only where its k-th and (k+1)-th probabilities lie within
# ROUTE_GAP. Given the card's routing on both sides, dispatch, experts and
# combine agree within |card - cpu| <= atol + rtol |cpu| (MOE_TOL): the
# experts' 1,024- and 512-term float32 sums in other orders, ~1e-6 of O(1)
# outputs.
MOE_TOKENS = 8192
ROUTE_GAP = 1e-5
MOE_TOL = (1e-5, 1e-5)
# A MoE twin (granite) pins its routing: each call of the kernel run routes as
# the plain run's same call did, so its logits part from the plain run's only
# by what the attention changes, as in a dense twin. The tokens whose own
# routing would choose other experts, and the widest k-th to (k+1)-th
# probability gap among them, are reported. In float32 (the attentions part
# by ~1e-6 relative) they must lie within ROUTE_GAP. In bfloat16 the
# attentions part by an ulp here and there, the router's inputs (unit RMS)
# by ~2^-8 of an element in many of their 1,024 elements, and its
# probabilities by up to ~1e-3 (a token was routed apart at a gap of 1.04e-3
# on an NVIDIA H100 80GB HBM3), as large as the gaps themselves: no gap there
# says the routing is sound, so none is required (None); the float32 layer
# of ``moe_on_card`` holds that.
TWIN_ROUTE_GAP = {torch.float32: ROUTE_GAP, torch.bfloat16: None}

# Road-network side of the main path. 512 (n = 262,144, the size of the New
# York network the paper starts from) is the target, but `build_bngraph` is
# host Python: on the 8-core host of one NVIDIA H100 80GB HBM3 it took 220 s
# at 384 and 602 s at 512, and at 512 this whole script took 667 s of the
# 1200 s it is allowed, on a host whose speed varies from run to run. At 384
# it takes 263-344 s. So 384 (n = 147,456); pass --grid 512 where time allows.
MAIN_GRID = 384
MAIN_GRID_REASON = (
    "384 not 512: with the host-side build_bngraph at 602 s the whole script took 667 s "
    "at 512 on the H100 machine, over half of its 1200 s limit; 263-344 s at 384"
)
# Road-network side of the certificate and CLI phases: the largest grid whose
# n (19,881) passes knn_build's dense-certificate gate n <= 20,000.
CERT_GRID = 141
# side of the square minplus product the kernel check times
MINPLUS_SIDE = 4096
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of ``fn()`` in milliseconds (CUDA events, warm)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries finite in either; +inf where exactly one is."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    return float(diff.max()) if diff.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality that counts NaN as equal to NaN (torch.equal
    does not): the same NaN positions, and equal values everywhere else."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


# ----------------------------------------------------------------------
# phase: kernels against their plain versions at full width
# ----------------------------------------------------------------------


def random_tables(n: int, cols: int, gen: torch.Generator, dev, id_range: int):
    """(n+1, cols) id/dist tables: ids in a small range (so neighbours share
    ids), small integer distances (so ties abound), ~15% invalid entries, and
    the dummy row (-1, +inf)."""
    ids = torch.randint(0, id_range, (n + 1, cols), generator=gen, device=dev, dtype=torch.int32)
    d = torch.randint(0, 64, (n + 1, cols), generator=gen, device=dev).to(torch.float32)
    bad = torch.rand((n + 1, cols), generator=gen, device=dev) < 0.15
    ids[bad] = -1
    d[bad] = float("inf")
    ids[n] = -1
    d[n] = float("inf")
    return ids, d


def sweep_schedule(rng, n: int, s: int, t: int, pads: int):
    """Targets from the lower half of the rows, neighbours from the upper half
    (disjoint, the level invariant), ~20% padded slots, duplicated neighbours
    in a tenth of the rows, and ``pads`` padded target rows aimed at row n."""
    verts = rng.choice(n // 2, size=s, replace=False).astype(np.int32)
    nbr = rng.integers(n // 2, n, size=(s, t), dtype=np.int64).astype(np.int32)
    dup = rng.random(s) < 0.1
    nbr[dup, 1] = nbr[dup, 0]
    w = rng.integers(1, 16, size=(s, t)).astype(np.float32)
    hole = rng.random((s, t)) < 0.2
    nbr[hole] = -1
    if pads:
        verts[-pads:] = n
        nbr[-pads:] = -1
    w[nbr < 0] = np.inf
    return nbr, verts, w


def rows_differ(got, want) -> int:
    """Entries at which two (ids, dists) results differ, in either part."""
    return int(((got[0] != want[0]) | ~((got[1] == want[1]) | (torch.isnan(got[1])
                                                            & torch.isnan(want[1])))).sum())


def topk_held(ids, d, k, what: str):
    """K1 on (ids, d) against its plain version, exactly; returns the result."""
    from repro_torch.kernels import ops, ref

    got = ops.topk_merge(ids, d, k)
    want = ref.topk_merge_ref(ids, d, k)
    torch.cuda.synchronize()
    bad = rows_differ(got, want)
    require(bad == 0 and got[1].dtype == want[1].dtype,
            f"topk_merge differs from its plain version {what}: {bad} of {want[0].numel()} entries")
    return got


def topk_bound(b: int, c: int, k: int) -> tuple[float, str]:
    """Each candidate read once (8 bytes), each output written once; one
    compare a candidate."""
    return bound(b * c * 8 + b * k * 8, 1.0 * b * c)


def check_topk_merge(cfg, dev, results) -> None:
    from repro_torch.kernels import ops, ref

    k = cfg.k
    b, c = cfg.level_batch, cfg.k + 64
    gen = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(0, 96, (b, c), generator=gen, device=dev, dtype=torch.int32)
    d = torch.randint(0, 32, (b, c), generator=gen, device=dev).to(torch.float32)
    bad = torch.rand((b, c), generator=gen, device=dev) < 0.1
    ids[bad] = -1
    ids[:64] = -1                 # all-invalid rows
    ids[64:128, 8:] = -1          # fewer distinct ids than k
    got = topk_held(ids, d, k, "at the usa shape")
    err = max_abs_err(got[1], ref.topk_merge_ref(ids, d, k)[1])
    # C < k and float16 distances
    topk_held(ids[:4096, :7].contiguous(), d[:4096, :7].contiguous(), k, "at C < k")
    half = topk_held(ids[:4096].contiguous(), d[:4096].to(torch.float16), k, "on float16")
    require(half[1].dtype == torch.float16, "topk_merge did not narrow float16 back")
    # every width on both sides of a register boundary (4 | 8 | 16 | 24 keys a
    # lane | groups of 768 - k), several groups, and a C past what the first
    # design's shared memory held (~29,000): 4,096 rows each, ids from a range
    # of C / 4 so that ids repeat and distances tie
    cases = {}
    for cw in (128, 129, 256, 257, 512, 513, 768, 769, 4000, 30000):
        rows_w = 4096 if cw <= 4000 else 64
        w_ids = torch.randint(-1, cw // 4, (rows_w, cw), generator=gen, device=dev,
                              dtype=torch.int32)
        w_d = torch.randint(0, 64, (rows_w, cw), generator=gen, device=dev).to(torch.float32)
        topk_held(w_ids, w_d, k, f"at C = {cw}")
        cases[cw] = {"rows": rows_w, "regs_group": ops.topk_plan(cw, k)}
    # the purge+merge of a flush: the k own entries plus hundreds of insert
    # candidates, at the full batch; checked and timed
    cw = k + 512
    wide_ids = torch.randint(-1, 600, (b, cw), generator=gen, device=dev, dtype=torch.int32)
    wide_d = torch.randint(0, 256, (b, cw), generator=gen, device=dev).to(torch.float32)
    topk_held(wide_ids, wide_d, k, "at C = k + 512")
    wide_bms, wide_by = topk_bound(b, cw, k)
    wide = {"shape": {"B": b, "C": cw, "k": k},
            "ms": cuda_ms(lambda: ops.topk_merge(wide_ids, wide_d, k)),
            "plain_ms": cuda_ms(lambda: ref.topk_merge_ref(wide_ids, wide_d, k), reps=3),
            "bound_ms": wide_bms, "bound_by": wide_by, "regs_group": ops.topk_plan(cw, k)}
    del wide_ids, wide_d
    ms = cuda_ms(lambda: ops.topk_merge(ids, d, k))
    plain_ms = cuda_ms(lambda: ref.topk_merge_ref(ids, d, k))
    bms, by = topk_bound(b, c, k)
    results["topk_merge"] = {
        "shape": {"B": b, "C": c, "k": k}, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "regs_group": ops.topk_plan(c, k), "wide": wide, "widths_checked": cases,
    }


def check_sweep_merge(cfg, dev, results) -> None:
    from repro_torch.kernels import ops, ref

    n, k, s, t = cfg.n_vertices, cfg.k, cfg.level_batch, cfg.tau
    gen = torch.Generator(device=dev).manual_seed(12)
    rng = np.random.default_rng(12)
    vk_ids, vk_d = random_tables(n, k, gen, dev, 4096)
    ex_ids, ex_d = random_tables(n, k, gen, dev, 4096)
    nbr_h, verts_h, w_h = sweep_schedule(rng, n, s, t, pads=1000)
    nbr, verts, w = (torch.from_numpy(x).to(dev) for x in (nbr_h, verts_h, w_h))

    want_ids, want_d = ref.sweep_merge_ref(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k)
    # tile form: tables only read
    tile_ids, tile_d = ops.sweep_merge(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k)
    torch.cuda.synchronize()
    require(torch.equal(tile_ids, want_ids) and torch.equal(tile_d, want_d),
            "sweep_merge (tile form) differs from its plain version")
    err = max_abs_err(tile_d, want_d)
    # in place, as one level of the one-launch sweep: rows verts get the
    # merged rows, every other row (the dummy row included, which the padded
    # rows aim at) keeps its content
    exp_ids, exp_d = vk_ids.clone(), vk_d.clone()
    live = verts != n
    exp_ids[verts[live].long()] = want_ids[live]
    exp_d[verts[live].long()] = want_d[live]
    run_ids, run_d = vk_ids.clone(), vk_d.clone()
    one_level = torch.tensor([[0, 0, s]], dtype=torch.int32, device=dev)
    ops.sweep_merge_levels([(nbr, w, verts)], one_level, ex_ids, ex_d, run_ids, run_d, k)
    torch.cuda.synchronize()
    require(torch.equal(run_ids, exp_ids) and torch.equal(run_d, exp_d),
            "sweep_merge_levels (one level, in place) differs from its plain version")
    require(bool((run_ids[n] == -1).all()) and bool(torch.isinf(run_d[n]).all()),
            "sweep_merge_levels wrote the dummy row")
    del exp_ids, exp_d
    # neighbours walked in groups (forced: 3 neighbours a group in place of 32)
    sub = slice(0, 8192)
    grp = ops.sweep_merge(nbr[sub], verts[sub], w[sub], ex_ids, ex_d, vk_ids, vk_d, k,
                          t_group=3)
    require(torch.equal(grp[0], want_ids[sub]) and torch.equal(grp[1], want_d[sub]),
            "sweep_merge (grouped neighbours) differs from its plain version")
    # wide row sets, as the repair rounds see (tables as their own extras): T = 512
    # and T = 677 (the combined BNS width of a 384 x 384 network), walked in
    # groups of 37 neighbours (a warp's 768 candidate registers)
    for t_wide in (512, 677):
        nbr2_h, verts2_h, w2_h = sweep_schedule(rng, n, 2048, t_wide, 16)
        nbr2, verts2, w2 = (torch.from_numpy(x).to(dev) for x in (nbr2_h, verts2_h, w2_h))
        wide = ops.sweep_merge(nbr2, verts2, w2, vk_ids, vk_d, vk_ids, vk_d, k)
        wide_w = ref.sweep_merge_ref(nbr2, verts2, w2, vk_ids, vk_d, vk_ids, vk_d, k)
        torch.cuda.synchronize()
        require(torch.equal(wide[0], wide_w[0]) and torch.equal(wide[1], wide_w[1]),
                f"sweep_merge (T = {t_wide}) differs from its plain version")
    del nbr2, verts2, w2, wide, wide_w

    ms = cuda_ms(lambda: ops.sweep_merge(nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k))
    plain_ms = cuda_ms(lambda: ref.sweep_merge_ref(
        nbr, verts, w, ex_ids, ex_d, vk_ids, vk_d, k), reps=5)
    # the same rows in place, one level of the one-launch sweep (idempotent:
    # its neighbours are never its targets)
    in_place_ms = cuda_ms(lambda: ops.sweep_merge_levels(
        [(nbr, w, verts)], one_level, ex_ids, ex_d, run_ids, run_d, k))
    distinct = int(torch.unique(nbr[nbr >= 0]).numel())
    slots = int((nbr >= 0).sum())
    # bytes: 8 a neighbour slot and 4 a row of schedule, each distinct
    # neighbour row and each row's extras read once, the (S, k) tile written;
    # operations: one add and one min a candidate (T*k gathered, E extras)
    nbytes = slots * 8 + s * 4 + distinct * k * 8 + s * k * 8 + s * k * 8
    bms, by = bound(nbytes, 2.0 * (slots * k + s * k))
    results["sweep_merge"] = {
        "shape": {"n": n, "S": s, "T": t, "k": k, "E": k, "neighbour_slots": slots},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "in_place_one_level_ms": in_place_ms,
        "sass": kernel_sass("sweep_merge", "sweep_merge_kernel"),
    }
    del nbr, verts, w, run_ids, run_d, tile_ids, tile_d, want_ids, want_d, vk_ids, vk_d
    torch.cuda.empty_cache()
    check_sweep_levels(cfg, dev, results, ex_ids, ex_d, rng)


def synthetic_levels(rng, n: int, n_levels: int):
    """A sweep of ``n_levels`` levels over vertices of 0..n-1: sizes
    log-uniform over 1-20,000 rows, widths from 1 to 200 neighbours (buckets
    4 to 256, the widest walked in groups), neighbours drawn from the level
    before (half) and from any earlier level, 20% of the slots empty, integer
    weights 1-15."""
    sizes = np.exp(rng.uniform(0, np.log(20000), size=n_levels)).astype(np.int64) + 1
    perm = rng.permutation(n)[: int(sizes.sum())].astype(np.int32)
    widths = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 32, 37, 48, 64, 100, 200)
    levels, at, prev, done = [], 0, None, []
    for size in sizes:
        verts = perm[at : at + size]
        at += size
        width = int(rng.choice(widths))
        nbr = np.full((size, width), -1, np.int32)
        if prev is not None:
            pool = np.concatenate(done)
            pick = np.where(rng.random((size, width)) < 0.5, rng.choice(prev, size=(size, width)),
                            rng.choice(pool, size=(size, width)))
            nbr = np.where(rng.random((size, width)) < 0.8, pick, -1).astype(np.int32)
        w = np.where(nbr >= 0, rng.integers(1, 16, size=nbr.shape), np.inf).astype(np.float32)
        # each row's neighbours first, as pack_sweep takes them
        first = np.argsort(nbr < 0, axis=1, kind="stable")
        levels.append((verts, np.take_along_axis(nbr, first, 1), np.take_along_axis(w, first, 1)))
        prev = verts
        done.append(verts)
    return levels


def check_sweep_levels(cfg, dev, results, ex_ids, ex_d, rng) -> None:
    """K2's one-launch sweep (``ops.sweep_merge_levels``, through
    ``construct.run_sweep``) against the plain version walked level by level,
    on a synthetic many-level sweep at the ``knn-index-usa`` table size."""
    from repro_torch.core import construct
    from repro_torch.kernels import ops

    n, k = cfg.n_vertices, cfg.k
    levels = synthetic_levels(rng, n, 200)
    plan = construct.pack_sweep(n, "up", levels, device=dev)
    rows = sum(v.size for v, _, _ in levels)
    slots = sum(int((nb >= 0).sum()) for _, nb, _ in levels)
    del levels
    distinct = int(torch.unique(torch.cat([b.nbr[b.nbr >= 0] for b in plan.buckets])).numel())
    got = construct.run_sweep(plan, ex_ids, ex_d, k)
    want = construct.run_sweep(plan, ex_ids, ex_d, k, use_kernel=False)
    torch.cuda.synchronize()
    differ = int(((got[0] != want[0]) | (got[1] != want[1])).any(dim=1).sum())
    require(differ == 0, f"sweep_merge_levels differs from the plain version walked level by "
                         f"level in {differ} of {rows} rows")
    require(bool((got[0][:n] >= 0).any()), "the synthetic sweep wrote nothing")
    err = max_abs_err(got[1], want[1])
    del want
    buckets = [(b.nbr, b.w, b.verts) for b in plan.buckets]
    grid = ops.sweep_merge_levels(buckets, plan.levels, ex_ids, ex_d, *got, k)
    ms = cuda_ms(lambda: ops.sweep_merge_levels(buckets, plan.levels, ex_ids, ex_d, *got, k),
                 reps=3)
    plain_ms = cuda_ms(lambda: ops.sweep_merge_levels(buckets, plan.levels, ex_ids, ex_d, *got,
                                                      k, use_kernel=False), reps=1)
    # bytes: the schedule (8 bytes a neighbour slot, not the buckets' padded
    # cells, and 4 a row), each written row's extras read and its k entries
    # written, each distinct neighbour row read; operations: one add and one
    # min a candidate (k a neighbour slot, E = k extras a row)
    nbytes = slots * 8 + rows * 4 + 2 * rows * k * 8 + distinct * k * 8
    bms, by = bound(nbytes, 2.0 * (slots * k + rows * k))
    results["sweep_merge_levels"] = {
        "shape": {"n": n, "levels": plan.num_levels, "rows": rows, "neighbour_slots": slots,
                  "buckets": list(plan.bucket_signature()), "k": k, "E": k},
        "grid_blocks": grid, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "sass": kernel_sass("sweep_merge", "sweep_levels_kernel"),
    }


def frontier_case(dev, seed: int, n: int, r: int, t: int, b: int, idle: bool = False):
    """One relaxation round's inputs: receivers that neighbour each other
    (half of the neighbours are receivers themselves), ~20% padded slots,
    padded receiver rows aimed at row n, sources that ARE neighbours (the
    gate's second arm) and up to three padded source columns; with ``idle``,
    a few real receivers whose every slot is padded."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    dist = torch.rand((n + 1, b), generator=gen, device=dev) * 100.0
    far = torch.rand((n + 1, b), generator=gen, device=dev) < 0.6
    dist[far] = float("inf")
    dist[n] = float("inf")
    del far
    kth = torch.rand((n + 1,), generator=gen, device=dev) * 100.0
    kth[n] = float("inf")
    rows_h = rng.choice(n, size=r, replace=False).astype(np.int32)
    nbr_h = rng.integers(0, n, size=(r, t), dtype=np.int64).astype(np.int32)
    own = rng.random((r, t)) < 0.5
    nbr_h[own] = rows_h[rng.integers(0, r, size=int(own.sum()))]
    w_h = rng.integers(1, 16, size=(r, t)).astype(np.float32)
    nbr_h[rng.random((r, t)) < 0.2] = -1
    pads = max(1, r // 256)
    rows_h[-pads:] = n
    nbr_h[-pads:] = -1
    if idle:
        nbr_h[: max(1, r // 512)] = -1
    w_h[nbr_h < 0] = np.inf
    src_h = nbr_h[-pads - b : -pads, 0].copy() if idle else nbr_h[:b, 0].copy()
    src_h[src_h < 0] = 5
    src_pads = min(3, b - 1)
    if src_pads:
        src_h[-src_pads:] = -1
        dist[:, -src_pads:] = float("inf")
    nbr, rows, w, src = (torch.from_numpy(x).to(dev) for x in (nbr_h, rows_h, w_h, src_h))
    return nbr, rows, w, dist, kth, src


def bucket_tables(nbr, rows, w, n1: int):
    """The (n+1, T) bucket tables the engine's fused entry reads: receiver
    rows' schedules at their rows, every other row (the dummy row too) pads."""
    t = nbr.shape[1]
    nbr_tab = torch.full((n1, t), -1, dtype=torch.int32, device=nbr.device)
    w_tab = torch.full((n1, t), float("inf"), dtype=torch.float32, device=nbr.device)
    nbr_tab[rows.long()] = nbr
    w_tab[rows.long()] = w
    return nbr_tab, w_tab


def relax_held(case, tables, what: str) -> dict:
    """Both K3 entries against their plain versions on one case, exactly:
    the JAX-shaped ``frontier_relax`` and the engine's ``frontier_relax_rows``
    (tile and changed mask). The plain versions run first, on the pristine
    matrix, and the receivers' rows of ``dist`` must be unchanged after both
    kernels (Jacobi: the kernel only reads it)."""
    from repro_torch.kernels import ops, ref

    nbr, rows, w, dist, kth, src = case
    idx = rows.long()
    before = dist[idx].clone()
    want = ref.frontier_relax_ref(*case)
    want_changed = (want < before).any(dim=1)
    got = ops.frontier_relax(*case)
    got_r, changed = ops.frontier_relax_rows(*tables, rows, dist, kth, src)
    torch.cuda.synchronize()
    counts = {"tile": int((got != want).sum()), "rows_tile": int((got_r != want).sum()),
              "changed": int((changed != want_changed).sum()),
              "dist_written": int((dist[idx] != before).sum())}
    r, t = nbr.shape
    require(not any(counts.values()),
            f"frontier_relax differs from its plain version {what} (R={r}, T={t}, "
            f"B={dist.shape[1]}): entries differing {counts} of {want.numel()}")
    require(bool(want_changed.any()), f"frontier_relax case {what} relaxed nothing")
    return {"R": r, "T": t, "B": dist.shape[1],
            "vec_split": ops.frontier_plan(r, dist.shape[1], dist.data_ptr(),
                                           ops.resident_warps(dist.device)),
            "changed_rows": int(want_changed.sum())}


def frontier_bound(nbr, b: int) -> tuple[float, str]:
    """The schedule (R*T*8), the receivers' ids, the distinct neighbour rows
    (B*4 + a 4-byte bound each), the own rows and src read once, the tile
    written once; 3 operations per valid slot and column."""
    r, t = nbr.shape
    valid = nbr >= 0
    distinct = int(torch.unique(nbr[valid]).numel())
    nbytes = r * t * 8 + r * 4 + distinct * (b * 4 + 4) + r * b * 4 + b * 4 + r * b * 4
    return bound(nbytes, 3.0 * int(valid.sum()) * b)


def check_frontier_relax(cfg, dev, results) -> None:
    from repro_torch.kernels import ops, ref

    # flush-sized cases: one source column, B not a multiple of 4 without the
    # engine's padding (475) and with it (476), bucket widths 8 / 32 / 128 and
    # 200 (seven 32-slot passes), receivers whose every slot is padded, and
    # receivers few enough that each (row, column chunk) gets a warp of its
    # own (1,000 rows: 4 chunks of 128 columns at B = 476, 15 of 32 at 475)
    cases = []
    for seed, r, t, b in ((14, 16384, 128, 475), (15, 16384, 8, 1), (16, 16384, 32, 476),
                          (17, 16384, 200, 64), (18, 16384, 128, 2), (19, 1000, 200, 476),
                          (20, 1000, 200, 475)):
        case = frontier_case(dev, seed, 1 << 18, r, t, b, idle=True)
        cases.append(relax_held(case, bucket_tables(case[0], case[1], case[2], (1 << 18) + 1),
                                f"in flush-sized case {len(cases)}"))
        del case
    torch.cuda.empty_cache()

    n, r, t, b = cfg.n_vertices, cfg.level_batch, cfg.tau, 64
    case = frontier_case(dev, 13, n, r, t, b)
    nbr, rows, w, dist, kth, src = case
    tables = bucket_tables(nbr, rows, w, n + 1)
    cases.append(relax_held(case, tables, "at the usa shape"))
    got = ops.frontier_relax(*case)
    err = max_abs_err(got, ref.frontier_relax_ref(*case))
    ms = cuda_ms(lambda: ops.frontier_relax(*case))
    rows_ms = cuda_ms(lambda: ops.frontier_relax_rows(*tables, rows, dist, kth, src))
    plain_ms = cuda_ms(lambda: ref.frontier_relax_ref(*case))
    rows_plain_ms = cuda_ms(lambda: ref.frontier_relax_rows_ref(*tables, rows, dist, kth, src))
    bms, by = frontier_bound(nbr, b)
    results["frontier_relax"] = {
        "shape": {"n": n, "R": r, "T": t, "B": b}, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "rows_ms": rows_ms, "rows_plain_ms": rows_plain_ms, "cases": cases,
    }


def minplus_bound(m: int, kd: int, n: int) -> tuple[float, str]:
    """Each input read once, the output written once; one add and one min per
    (i, t, j) term."""
    return bound((m * kd + kd * n + m * n) * 4, 2.0 * m * kd * n)


def check_minplus(cfg, dev, results) -> None:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(15)

    def case(m, kd, n, inf_frac=0.3):
        """Adjacency-like operands: small integer weights (ties abound, sums
        exact), a share of +inf entries."""
        a = torch.randint(0, 64, (m, kd), generator=gen, device=dev).to(torch.float32)
        b = torch.randint(0, 64, (kd, n), generator=gen, device=dev).to(torch.float32)
        a[torch.rand((m, kd), generator=gen, device=dev) < inf_frac] = float("inf")
        b[torch.rand((kd, n), generator=gen, device=dev) < inf_frac] = float("inf")
        return a, b

    # edges that are not multiples of the 128 x 128 tile or the 32-deep slice
    a, b = case(1000, 1537, 3001)
    require(torch.equal(ops.minplus_matmul(a, b), ref.minplus_matmul_ref(a, b)),
            "minplus differs from its plain version at (1000, 1537, 3001)")
    # +inf rows and columns, and one NaN that must spread along its row
    a, b = case(777, 513, 1029)
    a[5] = float("inf")
    b[:, 7] = float("inf")
    a[10, 20] = float("nan")
    got, want = ops.minplus_matmul(a, b), ref.minplus_matmul_ref(a, b)
    require(same_nan(got, want), "minplus differs from its plain version with +inf and NaN")
    require(bool(torch.isnan(got[10]).all()) and int(torch.isnan(got).sum()) == got.shape[1],
            "minplus did not propagate the NaN along exactly its row")
    col7 = torch.cat([got[:10, 7], got[11:, 7]])  # row 10 is NaN throughout
    require(bool(torch.isinf(got[5]).all()) and bool(torch.isinf(col7).all()),
            "minplus: an all-+inf row or column came out finite")
    # block-sparse operands with the traps of the slice predicate: an all-+inf
    # A slice facing a B slice with one -inf (+inf + -inf is NaN), another
    # facing one NaN, an A slice with a single finite entry, ragged edges; the
    # pairs the kernel walks must be those the plain slice bits give
    for m, kd, n in ((1000, 1537, 3001), (300, 97, 270)):
        a, b = block_sparse(gen, dev, m, kd, n)
        pairs = torch.zeros(1, dtype=torch.int64, device=dev)
        got, want = ops.minplus_matmul(a, b, pairs=pairs), ref.minplus_matmul_ref(a, b)
        differ = int((torch.isnan(got) != torch.isnan(want)).sum()
                     + ((got != want) & ~torch.isnan(got) & ~torch.isnan(want)).sum())
        require(differ == 0, f"minplus differs from its plain version on the block-sparse "
                             f"case ({m}, {kd}, {n}) in {differ} entries")
        require(bool(torch.isnan(want).any()) and bool((want == float("-inf")).any()),
                "the block-sparse case lost its NaN or -inf trap")
        live = int(ref.minplus_live_counts(*ref.minplus_slice_bits(a, b)).sum())
        require(int(pairs) == live, f"minplus walked {int(pairs)} pairs, the slice bits give {live}")
    # narrow types: widened to float32 and narrowed back, as the plain version
    for dt in (torch.float16, torch.bfloat16):
        h, hb = (x.to(dt) for x in case(300, 257, 700))
        got = ops.minplus_matmul(h, hb)
        require(got.dtype == dt and torch.equal(got, ref.minplus_matmul_ref(h, hb)),
                f"minplus differs from its plain version in {dt}")
    # the 4096^3 case, timed
    m = kd = n = MINPLUS_SIDE
    a, b = case(m, kd, n)
    got, want = ops.minplus_matmul(a, b), ref.minplus_matmul_ref(a, b)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "minplus differs from its plain version at 4096^3")
    err = max_abs_err(got, want)
    del got, want
    ms = cuda_ms(lambda: ops.minplus_matmul(a, b))
    plain_ms = cuda_ms(lambda: ref.minplus_matmul_ref(a, b), reps=3)
    bms, by = minplus_bound(m, kd, n)
    clocks = sm_clocks()
    results["minplus"] = {
        "shape": {"M": m, "K": kd, "N": n}, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        "dense_floor_ms": dense_floor_ms(m * kd * n, clocks["max_mhz"]), "sm_clock": clocks,
        "sass": kernel_sass("minplus", "minplus_kernel"),
    }


def block_sparse(gen, dev, m: int, kd: int, n: int):
    """+inf almost everywhere, a third of the 128 x 32 (A) and 32 x 128 (B)
    slices holding finite entries, and the traps the slice predicate must
    meet (see check_minplus)."""
    from repro_torch.kernels import ref

    tile, depth = ref.MINPLUS_TILE, ref.MINPLUS_DEPTH

    def side(rows, cols, sr, sc):
        x = torch.randint(0, 64, (rows, cols), generator=gen, device=dev).to(torch.float32)
        x[torch.rand((rows, cols), generator=gen, device=dev) < 0.7] = float("inf")
        keep = torch.rand((-(-rows // sr), -(-cols // sc)), generator=gen, device=dev) < 0.33
        keep = keep.repeat_interleave(sr, 0)[:rows].repeat_interleave(sc, 1)[:, :cols]
        return torch.where(keep, x, float("inf"))

    a, b = side(m, kd, tile, depth), side(kd, n, depth, tile)
    a[:tile, depth : 2 * depth] = float("inf")
    b[depth + 1, 3] = float("-inf")
    a[tile : 2 * tile, 2 * depth : 3 * depth] = float("inf")
    b[2 * depth + 2, tile + 5] = float("nan")
    a[2 * tile : 3 * tile, :depth] = float("inf")
    a[2 * tile + 7, 3] = 1.5
    return a, b


def sm_clocks() -> dict:
    """The SM clock now and its maximum, in MHz, as nvidia-smi reads them."""
    now, top = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].split(",")
    return {"now_mhz": float(now), "max_mhz": float(top)}


def dense_floor_ms(terms: float, mhz: float) -> float:
    """K4's floor on the CUDA cores: each (i, t, j) term is two issue slots
    (an add and a min, which do not fuse), 16,896 lanes at ``mhz``."""
    return 2.0 * terms / (SM_LANES * mhz * 1e6) * 1e3


# ----------------------------------------------------------------------
# phase: the BN-Graph certificate at grid 141 (minplus on its path)
# ----------------------------------------------------------------------


def certify(grid: int, dev, results) -> dict:
    from repro_torch import knn
    from repro_torch.core import verify
    from repro_torch.kernels import ops, ref

    out: dict = {"phase": "certify", "grid": grid}
    g = knn.road_network(grid, grid, seed=0)
    t0 = time.perf_counter()
    bn = knn.build_bngraph(g)
    out.update(n=bn.n, bngraph_s=time.perf_counter() - t0)
    require(bn.n <= 20000, f"grid {grid} is past knn_build's certificate gate n <= 20000")

    ops.reset_launches()  # ---- the certificate's launches are counted from here ----
    t0 = time.perf_counter()
    cert = verify.certificate(bn)
    torch.cuda.synchronize()
    out["certificate_s"] = time.perf_counter() - t0
    out["launches"] = ops.launches()  # ---- read right after it ----
    out["certificate"] = cert
    require(cert["ok"], f"BN-Graph certificate failed: {cert}")
    require(out["launches"]["minplus"] > 0, "the certificate launched no minplus kernel")

    # its parts, timed one by one: host adjacency, the kernel, host rank check
    t0 = time.perf_counter()
    a_h = verify.bngraph_dense_adjacency(bn)
    out["dense_adjacency_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(verify.rank_consistent(bn), "rank check failed")
    out["rank_check_s"] = time.perf_counter() - t0
    a = torch.from_numpy(a_h).to(dev)
    del a_h
    n = bn.n
    ms = cuda_ms(lambda: ops.minplus_matmul(a, a), reps=3)
    clocks = sm_clocks()
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    sq = ops.minplus_matmul(a, a, pairs=pairs)
    counts = ref.minplus_live_counts(*ref.minplus_slice_bits(a, a))
    require(int(pairs) == int(counts.sum()),
            f"the certificate's square walked {int(pairs)} pairs, the slice bits give "
            f"{int(counts.sum())}")
    # what this input needs: A (= B) read once and C written once, and one add
    # and one min for each term finite on both sides
    fin = torch.isfinite(a)
    finite_terms = int((fin.sum(0).double() * fin.sum(1).double()).sum())
    del fin
    # the plain version on 512 sampled rows (the whole square takes it ~40 s
    # on an H100 80GB HBM3 at 700 W, and the plain-version certificate below
    # computes that once anyway)
    rows = torch.from_numpy(np.random.default_rng(3).choice(n, 512, replace=False)).to(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    plain_rows = ref.minplus_matmul_ref(a[rows], a)
    e1.record()
    torch.cuda.synchronize()
    require(torch.equal(sq[rows], plain_rows),
            "certificate square differs from the plain version on 512 sampled rows")
    out.update(sampled_rows_equal=512, sampled_rows_max_abs_err=max_abs_err(sq[rows], plain_rows),
               sampled_rows_plain_ms=e0.elapsed_time(e1))
    del sq, a, rows, plain_rows
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cert_plain = verify.certificate(bn, use_kernel=False)
    torch.cuda.synchronize()
    out["certificate_plain_s"] = time.perf_counter() - t0
    require(cert_plain == cert, f"plain-version certificate differs: {cert_plain} vs {cert}")

    # one edge weight corrupted upward: a shorter two-hop path now exists
    for v in range(bn.n):
        sel = bn.lo_ids[v] >= 0
        if sel.sum() >= 2:
            bn.lo_w[v][np.argmax(sel)] += 100.0
            break
    stable = verify.relaxation_stable(bn)
    require(not stable, "relaxation check passed a corrupted BN-Graph")
    out["corrupted_relaxation_stable"] = stable
    torch.cuda.empty_cache()

    bms, by = bound(2 * n * n * 4, 2.0 * finite_terms)
    n_t = -(-n // ref.MINPLUS_DEPTH)
    out["kernel"] = {
        "shape": {"M": n, "K": n, "N": n}, "ms": ms, "bound_ms": bms, "bound_by": by,
        "finite_terms": finite_terms, "pairs_walked": int(pairs),
        "pairs_total": counts.numel() * n_t, "pairs_live_share": int(pairs) / (counts.numel() * n_t),
        "pairs_max_per_tile": int(counts.max()), "t_slices": n_t,
        "dense_floor_ms": dense_floor_ms(float(n) ** 3, clocks["max_mhz"]), "sm_clock": clocks,
    }
    return out


# ----------------------------------------------------------------------
# phase: the command-line entry points, in subprocesses
# ----------------------------------------------------------------------


def run_cli(module: str, args: list[str], timeout: float, phase: str = "cli",
            json_out: bool = True) -> tuple[dict | None, list[str]]:
    """Run ``python -m module args`` from the checkout: (the JSON object its
    stdout is, or ends with, else None; its stdout lines). A non-zero exit
    fails the phase, and so does stdout without that object when
    ``json_out``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), timeout=timeout)
    command = f"python -m {module} {' '.join(args)}"
    if proc.returncode != 0:
        raise AssertionError(f"{command} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    result, printed = None, lines
    for text, rest in ((proc.stdout, []), (lines[-1] if lines else "", lines[:-1])):
        try:
            result, printed = json.loads(text), rest
            break
        except json.JSONDecodeError:
            pass
    if json_out and not isinstance(result, dict):
        raise AssertionError(f"{command}: no JSON object on stdout: {lines[-3:]}")
    say({"phase": phase, "command": command, "seconds": time.perf_counter() - t0,
         "printed": printed[-12:], "result": result})
    return result, lines


def cli(grid: int, tmp: str) -> None:
    art = os.path.join(tmp, f"g{grid}.npz")
    common = ["--grid", str(grid), "--k", "20"]
    built, _ = run_cli("repro_torch.launch.knn_build", [*common, "--verify", "--out", art], 300)
    require(built["verified"] is True, "knn_build --verify: tables differ from the reference")
    require(built["bngraph_certificate"]["ok"] is True,
            f"knn_build --verify: certificate failed {built['bngraph_certificate']}")
    served, _ = run_cli("repro_torch.launch.serve",
                        ["--arch", "knn-index", *common, "--artifact", art, "--ops", "200000",
                         "--update-frac", "0.05", "--inject-flush-failure", "2"], 300)
    require(served["errors"] == 1 and "injected flush failure" in served["last_error"],
            f"serve: expected exactly the injected flush failure, got {served['errors']} "
            f"({served['last_error']})")
    require(served["updates"] > 0 and served["queries"] > 0, "serve: no traffic served")
    require(served["engine"]["staged_queue_depth"] == 0, "serve: updates left staged")
    fleet, _ = run_cli("repro_torch.launch.serve",
                       ["--arch", "knn-index", *common, "--workload", "fleet",
                        "--fleet-size", "200", "--ticks", "20"], 300)
    require(fleet["ticks"] == 20 and fleet["engine"]["flushes"] == 20,
            f"serve --workload fleet: {fleet['ticks']} ticks, {fleet['engine']['flushes']} flushes")
    require(fleet["sim"]["moves_total"] > 0, "serve --workload fleet: nothing moved")


# ----------------------------------------------------------------------
# phase: the main path
# ----------------------------------------------------------------------


class Both:
    """Stages every update on an engine and on its twins."""

    def __init__(self, engine, *twins):
        self.engine, self.twins = engine, twins
        self.n, self.k = engine.n, engine.k

    @property
    def objects(self):
        return self.engine.objects

    def stage_insert(self, u):
        for twin in self.twins:
            twin.stage_insert(u)
        return self.engine.stage_insert(u)

    def stage_delete(self, u):
        for twin in self.twins:
            twin.stage_delete(u)
        return self.engine.stage_delete(u)

    def stage_move(self, u, v):
        for twin in self.twins:
            twin.stage_move(u, v)
        return self.engine.stage_move(u, v)


def stage_traffic(knn, engine, mset: set, rng, n_random: int, n_deletes: int, n_moves: int) -> int:
    """``n_random`` updates from ``stage_random_updates`` (at 1% object density
    nearly all of them inserts), ``n_deletes`` deletions of present objects and
    ``n_moves`` moves of a present object to an absent vertex."""
    staged = knn.stage_random_updates(engine, mset, rng, n_random)
    # only objects of the flushed set, so the ops do not cancel this flush's inserts
    present = np.array(sorted(mset.intersection(engine.objects.tolist())))
    picked = rng.choice(present, size=min(present.size, n_deletes + n_moves), replace=False).tolist()
    for u in picked[:n_deletes]:
        engine.stage_delete(u)
        mset.discard(u)
        staged += 1
    for u in picked[n_deletes:]:
        v = int(rng.integers(0, engine.n))
        if u not in mset or v in mset:
            continue
        engine.stage_move(u, v)
        mset.discard(u)
        mset.add(v)
        staged += 1
    return staged


def main_path(grid: int, k: int, dev) -> tuple[dict, dict]:
    from repro_torch import knn
    from repro_torch.core.construct import build_knn_tables, object_extras, prepare_sweep, run_sweep
    from repro_torch.core.index import index_from_lists, KNNIndex
    from repro_torch.core.reference import dijkstra_knn
    from repro_torch.kernels import ops

    reason = MAIN_GRID_REASON if grid == MAIN_GRID else "set with --grid"
    out: dict = {"phase": "main_path", "grid": grid, "grid_reason": reason, "k": k}
    t0 = time.perf_counter()
    g = knn.road_network(grid, grid, seed=0)
    objects = knn.pick_objects(g.n, 0.01, seed=0)
    t1 = time.perf_counter()
    bn = knn.build_bngraph(g)
    t2 = time.perf_counter()
    out.update(n=g.n, m=g.m, objects=int(objects.size), gen_s=t1 - t0, bngraph_s=t2 - t1,
               tau=bn.tau, tau_all=bn.tau_all)

    # Before the main path, the same build in two timed halves: host (schedule
    # packing + upload) and device (the two sweeps); then the sweeps again with
    # the plain versions. The main path's tables are held against both.
    ta = time.perf_counter()
    plans = (prepare_sweep(bn, "up", device=dev), prepare_sweep(bn, "down", device=dev))
    torch.cuda.synchronize()
    tb = time.perf_counter()
    split = build_knn_tables(bn, objects, k, device=dev, plans=plans)
    torch.cuda.synchronize()
    tc = time.perf_counter()
    plain = build_knn_tables(bn, objects, k, device=dev, use_kernel=False, plans=plans)
    torch.cuda.synchronize()
    td = time.perf_counter()
    out.update(build_host_s=tb - ta, build_device_s=tc - tb, build_device_plain_s=td - tc,
               levels_up=plans[0].num_levels, levels_down=plans[1].num_levels,
               occupancy_up=plans[0].occupancy, occupancy_down=plans[1].occupancy)
    # each sweep alone, one launch each: device time (CUDA events, warm) and
    # its levels, so the time a level costs (a grid barrier and its rows)
    ex_ids, ex_d = object_extras(bn.n, objects, k, device=dev)
    up = run_sweep(plans[0], ex_ids, ex_d, k)
    out["sweeps"] = {}
    for plan, extras in ((plans[0], (ex_ids, ex_d)), (plans[1], up)):
        ms = cuda_ms(lambda: run_sweep(plan, *extras, k), reps=3)
        out["sweeps"][plan.direction] = {
            "ms": ms, "levels": plan.num_levels, "rows": plan.n,
            "us_per_level": ms * 1e3 / plan.num_levels,
            "levels_under_1k_rows": sum(size < 1000 for size in plan.level_sizes)}
    del plans, ex_ids, ex_d, up

    ops.reset_launches()  # ---- the main path's launches are counted from here ----
    t2 = time.perf_counter()
    engine = knn.build_engine(bn, objects, k)
    torch.cuda.synchronize()
    out["build_engine_s"] = time.perf_counter() - t2
    out["launches_build"] = ops.launches()
    require(out["launches_build"]["sweep_merge_levels"] == 2
            and out["launches_build"]["sweep_merge"] == 0,
            f"the build did not run as one K2 launch per sweep: {out['launches_build']}")
    require(torch.equal(split[0], engine.tables[0]) and torch.equal(split[1], engine.tables[1]),
            "two kernel builds differ")
    require(torch.equal(plain[0], engine.tables[0]) and torch.equal(plain[1], engine.tables[1]),
            "kernel build differs from plain-version build")
    # the twin: the plain-version tables behind an engine that launches no kernel
    twin = knn.QueryEngine.from_tables(plain[0].cpu().numpy(), plain[1].cpu().numpy(), k, objects,
                                       bn=bn, device=dev, use_kernel=False)
    del split, plain

    # 256 sampled vertices against Dijkstra on the road network itself
    rng = np.random.default_rng(7)
    sample = rng.choice(g.n, size=256, replace=False)
    is_obj = np.zeros(g.n, bool)
    is_obj[objects] = True
    want = index_from_lists(256, k, [dijkstra_knn(g, is_obj, k, int(u)) for u in sample])
    idx0 = engine.to_index()
    got = KNNIndex(ids=idx0.ids[sample], dists=idx0.dists[sample], k=k)
    require(knn.indices_equivalent(want, got), "tables differ from Dijkstra on the sample")
    out["dijkstra_sample"] = 256

    # 2^20 queries, mixed per-query k, against a direct table read
    nq = 1 << 20
    us = rng.integers(0, g.n, size=nq).astype(np.int32)
    ks = rng.integers(1, k + 1, size=nq).astype(np.int32)
    ids_h = engine.tables[0].cpu().numpy()
    d_h = engine.tables[1].cpu().numpy()
    q_ids, q_d = engine.query_batch(us, ks)
    cut = np.arange(k)[None, :] < ks[:, None]
    want_ids = np.where(cut, ids_h[us], -1)
    want_d = np.where(cut & (ids_h[us] >= 0), d_h[us], np.inf).astype(np.float32)
    require(np.array_equal(q_ids.cpu().numpy(), want_ids)
            and np.array_equal(q_d.cpu().numpy(), want_d), "query_batch differs from table read")
    torch.cuda.synchronize()
    tq = time.perf_counter()
    for _ in range(5):
        engine.query_batch(us, ks)
    torch.cuda.synchronize()
    out["queries_per_s"] = 5 * nq / (time.perf_counter() - tq)
    del ids_h, d_h, want_ids, want_d, q_ids, q_d

    # three flushes of mixed traffic; epoch 0 stays pinned. The combined BNS
    # adjacency the flushes walk is packed once per BN-Graph (host numpy):
    # timed here on its own so that the first flush does not carry it
    tp = time.perf_counter()
    bn.bns_packed()
    out["bns_packed_s"] = time.perf_counter() - tp
    engine.keep_epochs = 4
    pin_us = us[:4096]
    pin_ids, pin_d = (x.clone() for x in engine.query_batch(pin_us, epoch=0))
    mset = set(objects.tolist())
    both = Both(engine, twin)
    flushes = []
    for _ in range(3):
        staged = stage_traffic(knn, both, mset, rng, 300, 180, 180)
        phases = ("t_frontier_s", "t_purge_merge_s", "t_repair_s")
        before = engine.stats()
        tf = time.perf_counter()
        res = engine.flush_updates()
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - tf
        res.update({key: engine.stats()[key] - before[key] for key in phases})
        net = res["inserts"] + res["deletes"] + res["moves"]
        require(net >= 512 and res["inserts"] and res["deletes"] and res["moves"],
                f"flush too small or one-sided: {res}")
        res["staged"] = staged
        # the same flush through the plain versions only, at the very shapes the
        # kernels just ran at: same rounds, same tables bit for bit
        tf = time.perf_counter()
        res_twin = twin.flush_updates()
        torch.cuda.synchronize()
        res["plain_seconds"] = time.perf_counter() - tf
        require(all(res[key] == val for key, val in res_twin.items()),
                f"kernel flush and plain-version flush took different paths: {res} {res_twin}")
        require(torch.equal(engine.tables[0], twin.tables[0])
                and torch.equal(engine.tables[1], twin.tables[1]),
                "tables after a flush differ from the plain-version engine's")
        flushes.append(res)
    out["flushes"] = flushes
    out["launches"] = ops.launches()  # ---- read right after the main path ----
    del twin, both

    final = np.array(sorted(mset), dtype=np.int32)
    require(np.array_equal(engine.objects, final), "engine object set differs from the mirror")
    rebuilt = knn.build_index(bn, final, k)
    require(knn.indices_equivalent(rebuilt, engine.to_index()),
            "tables after three flushes differ from a rebuild on the final object set")
    again_ids, again_d = engine.query_batch(pin_us, epoch=0)
    require(torch.equal(again_ids, pin_ids) and torch.equal(again_d, pin_d),
            "epoch-pinned query changed across flushes")
    now_ids, _ = engine.query_batch(pin_us)
    require(not torch.equal(now_ids, pin_ids), "flushes changed nothing the pinned queries see")
    path_kernels = ("topk_merge", "sweep_merge", "sweep_merge_levels", "frontier_relax")
    require(all(out["launches"][name] > 0 for name in path_kernels),
            f"a kernel was not launched on the main path: {out['launches']}")
    # host-clock seconds of each flush phase over the launches it made, in ms:
    # what a launch costs the path at the shapes the path gives it, host work
    # and launch overhead included (an upper bound on the kernel's own time;
    # the kernels' own device time is the profiled flush below)
    phase_s = {key: sum(f[key] for f in flushes)
               for key in ("t_frontier_s", "t_purge_merge_s", "t_repair_s")}
    out["ms_per_launch"] = {
        "sweep_merge_repair": phase_s["t_repair_s"] * 1e3 / max(1, out["launches"]["sweep_merge"]),
        "frontier_relax": phase_s["t_frontier_s"] * 1e3 / out["launches"]["frontier_relax"],
        "topk_merge": phase_s["t_purge_merge_s"] * 1e3 / out["launches"]["topk_merge"],
    }
    out["profiled_flush"] = profiled_flush(knn, engine, mset, rng)
    return out, {"bn": bn, "engine": engine, "mset": mset, "objects": objects, "k": k}


def profiled_flush(knn, engine, mset: set, rng) -> dict:
    """One more flush of the same traffic under ``torch.profiler``, with a CUDA
    event pair around every kernel wrapper call as well: K1-K3's own device
    time at the shapes a flush gives them, and each K1 / K3 call's shape
    (B, C; R, T, B) and its bound there. The profiler reads kernels by name;
    the events (which also hold the wrapper's few tensor ops) stand in where
    the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    # the wrappers the engine calls, and the name of each one's kernel
    names = {"topk_merge": "topk_merge_kernel", "sweep_merge": "sweep_merge_kernel",
             "frontier_relax_rows": "frontier_relax_kernel"}
    events = {name: [] for name in names}
    calls = {name: [] for name in names}
    wrapped = {name: getattr(ops, name) for name in names}

    def timed(name):
        def call(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            result = wrapped[name](*args, **kwargs)
            e1.record()
            events[name].append((e0, e1))
            calls[name].append(args)  # the schedule and rows are not written later
            return result
        return call

    stage_traffic(knn, engine, mset, rng, 300, 180, 180)
    torch.cuda.synchronize()
    for name in names:
        setattr(ops, name, timed(name))
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = engine.flush_updates()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for name in names:
            setattr(ops, name, wrapped[name])
    out: dict = {"seconds": seconds, "rounds": {key: res[key] for key in res
                                                if key.endswith("rounds")}}
    busy_us = 0.0
    for row in prof.key_averages():
        # a kernel's row: device_type CUDA, its time as self device time
        if "CUDA" not in str(row.device_type):
            continue
        dev_us = max(row.self_device_time_total, row.device_time_total)
        busy_us += dev_us
        for name, kernel in names.items():
            if kernel in row.key:
                entry = out.setdefault(name, {})
                entry["profiler_ms"] = entry.get("profiler_ms", 0.0) + dev_us / 1e3
                entry["profiler_calls"] = entry.get("profiler_calls", 0) + row.count
    for name in names:
        ms = [e0.elapsed_time(e1) for e0, e1 in events[name]]
        out.setdefault(name, {}).update(
            calls=len(ms), event_ms_total=sum(ms),
            event_ms_per_call=statistics.median(ms) if ms else None)
        require(not ms or "profiler_ms" in out[name],
                f"the profiler shows no kernel named {names[name]} for {name}")
    # each call's shape and its bound there (as the kernel checks count them)
    shapes, bound_ms = [], 0.0
    for args in calls["topk_merge"]:
        b, c = args[0].shape
        k = args[2]
        shapes.append({"B": b, "C": c})
        bound_ms += topk_bound(b, c, k)[0]
    out["topk_merge"].update(shapes=shapes, bound_ms_total=bound_ms)
    shapes, bound_ms = [], 0.0
    for nbr_tab, _, rows, dist, *_ in calls["frontier_relax_rows"]:
        r, t, b = rows.shape[0], nbr_tab.shape[1], dist.shape[1]
        shapes.append({"R": r, "T": t, "B": b})
        bound_ms += frontier_bound(nbr_tab[rows.long()], b)[0]
    out["frontier_relax_rows"].update(shapes=shapes, bound_ms_total=bound_ms)
    out["device_busy_ms"] = busy_us / 1e3
    return out


# ----------------------------------------------------------------------
# phase: durability on the main path's engine
# ----------------------------------------------------------------------


class SimulatedKill(Exception):
    """Raised by the checkpoint hook to model the process dying there."""


def durability(state: dict, tmp: str) -> dict:
    """save -> load (tables equal); a journaled flush, then a second batch
    killed mid-repair; recovery from the artifact plus the journal, held
    equal to an uncrashed engine loaded from the same artifact that took the
    same ops at the same flush boundaries."""
    from repro_torch import knn

    engine, bn, mset = state["engine"], state["bn"], state["mset"]
    out: dict = {"phase": "durability", "n": engine.n, "k": engine.k}
    art, wal = os.path.join(tmp, "main.npz"), os.path.join(tmp, "wal.bin")
    t0 = time.perf_counter()
    engine.save(art)
    out.update(save_s=time.perf_counter() - t0, artifact_bytes=os.path.getsize(art))
    t0 = time.perf_counter()
    twin = knn.load_engine(art, bn=bn)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    require(torch.equal(twin.tables[0], engine.tables[0])
            and torch.equal(twin.tables[1], engine.tables[1]), "loaded tables differ from saved")

    journal = engine.attach_journal(wal)
    both = Both(engine, twin)
    rng = np.random.default_rng(21)
    out["staged_committed"] = stage_traffic(knn, both, mset, rng, 300, 180, 180)
    engine.flush_updates()
    twin.flush_updates()
    out["staged_killed"] = stage_traffic(knn, both, mset, rng, 300, 180, 180)
    out["journal_bytes"] = os.path.getsize(wal)

    def kill(e, phase):
        if phase == "mid-repair-round":
            raise SimulatedKill(phase)

    engine.checkpoint_hook = kill
    killed = False
    try:
        engine.flush_updates()
    except SimulatedKill:
        killed = True
    engine.checkpoint_hook = None
    journal.close()
    require(killed, "the second flush ran no repair round to kill")
    twin.flush_updates()

    t0 = time.perf_counter()
    with knn.UpdateJournal(wal) as wal_j:
        rec = knn.load_engine(art, bn=bn, journal=wal_j)
        torch.cuda.synchronize()
        out["recover_s"] = time.perf_counter() - t0
    require(rec.epoch == twin.epoch == 2, f"epochs: recovered {rec.epoch}, uncrashed {twin.epoch}")
    require(np.array_equal(rec.objects, twin.objects), "recovered object set differs")
    require(torch.equal(rec.tables[0], twin.tables[0])
            and torch.equal(rec.tables[1], twin.tables[1]),
            "recovered tables differ from the uncrashed engine's")
    out["recovered_epoch"] = rec.epoch
    return out


# ----------------------------------------------------------------------
# phase: the sharded engine (S logical shards on the card) on the main
# path's BN-Graph
# ----------------------------------------------------------------------


def logical(engine):
    """An engine's (n, k) tables in vertex order, on the card."""
    if hasattr(engine, "logical_tables"):
        return engine.logical_tables()
    return engine.tables[0][: engine.n], engine.tables[1][: engine.n]


def same_tables(a, b) -> bool:
    (ai, ad), (bi, bd) = logical(a), logical(b)
    return torch.equal(ai, bi) and torch.equal(ad, bd)


def sharded(state: dict, tmp: str) -> dict:
    """The vertex-sharded engine against the scalar engine on the main path's
    BN-Graph (its initial object set, a fresh scalar build): equal and auto
    builds, a 2^20-query batch, three collective flushes and one host-halo
    flush, a repartition with a pinned read, replicas under both policies,
    save at S = 4 and load at S = 1, 2 and 8 with a flush each. Tables
    ``torch.equal`` to the scalar engine's (logical row order) throughout.
    The launches are those of the sharded engines' own calls (builds,
    queries, flushes, repartition, replication, loads), the counts set to 0
    just before each and read just after; the scalar comparand's launches
    are not theirs and are not counted. Then ``serve --partition`` in a
    subprocess at grid 141."""
    from repro_torch import knn
    from repro_torch.kernels import ops

    bn, objects, k = state["bn"], state["objects"], state["k"]
    out: dict = {"phase": "sharded", "n": bn.n, "k": k, "shards": 4}
    own = {name: 0 for name in ops.launches()}  # the sharded engines' launches

    def counted(fn, *args, **kwargs):
        """``fn(...)``, a sharded engine's call, with the launch counts set to 0
        just before it and read just after; returns its result and the
        launches it made (also added to ``own``)."""
        ops.reset_launches()
        result = fn(*args, **kwargs)
        launched = {name: count for name, count in ops.launches().items() if count}
        for name, count in launched.items():
            own[name] += count
        return result, launched

    t_phase = time.perf_counter()
    scalar = knn.build_engine(bn, objects, k)
    t0 = time.perf_counter()
    eng, build_launches = counted(knn.build_sharded_engine, bn, objects, k, plan="shards=4")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    require(same_tables(eng, scalar), "S = 4 build differs from the scalar build")
    auto, auto_launches = counted(knn.build_sharded_engine, bn, objects, k,
                                  plan="shards=4,ranges=auto")
    out["launches_build"] = {"equal": build_launches, "auto": auto_launches}
    require(build_launches.get("sweep_merge_levels", 0) > 0
            and auto_launches.get("sweep_merge_levels", 0) > 0,
            f"a sharded build launched no sweep_merge_levels: {out['launches_build']}")
    require(same_tables(auto, scalar) and auto.stats()["uneven_ranges"],
            "ranges=auto build differs from the scalar build, or is not uneven")
    out["auto_starts"] = auto.stats()["shard_starts"]
    out["row_padding_overhead"] = {"equal": eng.stats()["row_padding_overhead"],
                                   "auto": auto.stats()["row_padding_overhead"]}
    del auto

    # one 2^20-query batch, mixed per-query k, routed across the shards
    rng = np.random.default_rng(31)
    nq = 1 << 20
    us = rng.integers(0, bn.n, size=nq).astype(np.int32)
    ks = rng.integers(1, k + 1, size=nq).astype(np.int32)
    got, want = counted(eng.query_batch, us, ks)[0], scalar.query_batch(us, ks)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "routed queries differ from the scalar engine's")
    for name, e in (("sharded", eng), ("scalar", scalar)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            e.query_batch(us, ks)
        torch.cuda.synchronize()
        out[f"queries_per_s_{name}"] = 5 * nq / (time.perf_counter() - t0)
    del got, want

    mset = set(objects.tolist())
    flushes = []

    def flush(engines, sizes=(300, 180, 180)):
        """The main path's traffic on every engine and the scalar one, each
        flushed: stats dicts and tables equal to the scalar engine's."""
        staged = stage_traffic(knn, Both(*engines, scalar), mset, rng, *sizes)
        recs = []
        for e in engines:
            before = e.stats()
            t0 = time.perf_counter()
            res, launched = counted(e.flush_updates)
            torch.cuda.synchronize()
            after = e.stats()
            recs.append({"shards": e.num_shards, "halo": e.halo, "staged": staged,
                         "seconds": time.perf_counter() - t0, **res,
                         **{key: after[key] - before[key]
                            for key in ("halo_rounds_collective", "halo_fallbacks")},
                         "launches": launched})
            # S > 1 merges every shard's rows in K1; S = 1 runs the scalar
            # engine's own rounds (K3 frontier, K2 repair)
            need = ("topk_merge",) if e.num_shards > 1 else ("frontier_relax", "sweep_merge")
            require(all(launched.get(name, 0) > 0 for name in need),
                    f"S = {e.num_shards} flush launched none of {need}: {launched}")
        t0 = time.perf_counter()
        want = scalar.flush_updates()
        torch.cuda.synchronize()
        for e, rec in zip(engines, recs):
            rec["scalar_seconds"] = time.perf_counter() - t0
            require(all(rec[key] == val for key, val in want.items()),
                    f"sharded flush took another path than the scalar one: {rec} {want}")
            require(same_tables(e, scalar),
                    f"S = {e.num_shards} ({e.halo} halo) tables differ after a flush")
        flushes.extend(recs)

    eng.keep_epochs = 4
    for _ in range(3):
        flush([eng])
    eng.halo = "host"
    flush([eng], sizes=(60, 36, 36))
    eng.halo = "collective"

    # a repartition flush under a skewed query histogram, a read pinned to the
    # epoch before it, one flush after it
    hot = rng.integers(0, int(eng.routing.starts[1]), size=nq // 2)
    starts = knn.propose_starts(np.bincount(np.concatenate([us, hot]), minlength=bn.n), 4)
    pin_us, e0 = us[:4096], eng.epoch
    pin = [x.clone() for x in eng.query_batch(pin_us)]
    t0 = time.perf_counter()
    counted(eng.repartition, starts)
    torch.cuda.synchronize()
    out["repartition"] = {"seconds": time.perf_counter() - t0, "starts": starts.tolist(),
                          "row_padding_overhead": eng.stats()["row_padding_overhead"]}
    require(eng.routing.starts.tolist() == starts.tolist() and same_tables(eng, scalar),
            "the repartition changed the tables or missed its boundaries")
    flush([eng])
    again = eng.query_batch(pin_us, epoch=e0)
    require(all(torch.equal(a, b) for a, b in zip(again, pin)),
            "a read pinned before the repartition changed")

    # replicas of the hottest shard under both policies: answers equal, every
    # replica buffer byte-identical to its primary's block
    hot_shard = int(np.argmax(np.bincount(eng.routing.owner(hot), minlength=4)))
    out["replicas"] = {}
    for policy in ("round_robin", "least_outstanding"):
        counted(eng.set_replication, {hot_shard: 2}, policy=policy)
        t0 = time.perf_counter()
        got = counted(eng.query_batch, us, ks)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want = scalar.query_batch(us, ks)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"replicated answers differ ({policy})")
        for epoch in eng.retained_epochs():
            bufs = eng.routing.replica_buffers(epoch)
            require(all(torch.equal(b[2], bufs[b[0]][2]) and torch.equal(b[3], bufs[b[0]][3])
                        for slot, b in bufs.items() if slot >= eng.num_shards),
                    f"a replica buffer differs from its primary (epoch {epoch})")
        st = eng.stats()
        out["replicas"][policy] = {"shard": hot_shard, "seconds": seconds,
                                   **{key: st[key] for key in ("replica_slots",
                                      "replica_queries", "replica_batches", "replica_errors")}}
    eng.set_replication(None)

    # save at S = 4; load at S = 1, 2 and 8 (reshard-on-load), a flush each
    art = os.path.join(tmp, "sharded.npz")
    eng.save(art)
    loaded = [counted(knn.load_engine, art, bn=bn, plan=f"shards={s}")[0] for s in (1, 2, 8)]
    require(all(same_tables(e, eng) for e in loaded), "tables differ after reshard-on-load")
    flush(loaded)
    out["flushes"] = flushes
    out["stats"] = {key: eng.stats()[key] for key in (
        "shard_rows", "padded_rows", "row_padding_overhead", "shard_starts", "repartitions",
        "halo_rounds_collective", "halo_fallbacks", "epoch")}
    out["launches"] = own
    del loaded
    # the sanitize phase flushes these two again, under the sync guard
    state["sharded_engines"] = {"scalar": scalar, "sharded": eng}
    del eng, scalar
    require(all(out["launches"][name] > 0
                for name in ("topk_merge", "sweep_merge", "sweep_merge_levels", "frontier_relax")),
            f"a kernel was not launched on the sharded path: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase

    served, _ = run_cli("repro_torch.launch.serve",
                        ["--arch", "knn-index", "--grid", str(CERT_GRID), "--k", "20",
                         "--partition", "shards=4,ranges=auto", "--hot-shard", "0",
                         "--hot-frac", "0.8", "--ops", "50000"], 300, phase="sharded_serve")
    require(served["errors"] == 0 and served["updates"] > 0 and served["queries"] > 0,
            "serve --partition: no traffic served, or a flush failed")
    require(served["partition"]["shards"] == 4 and served["engine"]["num_shards"] == 4,
            f"serve --partition: {served['partition']}")
    require(len(served["repartition_rounds"]) >= 1,
            "serve --partition ranges=auto: the skewed traffic triggered no re-split")
    out["serve"] = {key: served[key] for key in ("queries_per_s", "updates_per_s",
                                                 "repartition_rounds", "balance_ratio")}
    return out


# ----------------------------------------------------------------------
# phase: the sanitizer rail on the card, on the sharded phase's engines
# ----------------------------------------------------------------------

_BUILD_PROBE = """
import json, sys
import numpy as np
from repro_torch import knn
from repro_torch.analysis import sanitize
from repro_torch.kernels import _build

# the parent's build directory, named through REPRO_COMPILE_CACHE
assert sanitize.enable_compile_cache() == _build.build_dir()
g = knn.road_network(24, 24, seed=1)
objects = knn.pick_objects(g.n, 0.05, seed=1)
bn = knn.build_bngraph(g)
counts = {}
for api, make in (("", knn.build_engine), ("sharded_", lambda *a: knn.build_sharded_engine(
        *a, plan="shards=4"))):
    with sanitize.count_builds() as c:
        eng = make(bn, objects, 8)
    counts[api + "build"] = c.count
    with sanitize.count_builds() as c:
        eng.query_batch(np.arange(g.n, dtype=np.int32))
    counts[api + "query_batch"] = c.count
    absent = [v for v in range(g.n) if v not in set(objects.tolist())][:16]
    for v in absent:
        eng.stage_insert(v)
    for v in objects[:8].tolist():
        eng.stage_delete(v)
    with sanitize.count_builds() as c:
        eng.flush_updates()
    counts[api + "flush_updates"] = c.count
print(json.dumps({"build_dir": str(_build.build_dir()), "builds": counts}))
"""


def sanitize_phase(state: dict, built: list[str]) -> dict:
    """The runtime rail on the card. A sync planted under ``no_transfers``
    must raise ``SanitizerError`` (the guard is live). Then, in sanitizer
    mode (``REPRO_SANITIZE=1``), one 2^20-query batch and one staged flush
    through the sharded phase's grid-384 scalar engine and one collective
    flush through its S = 4 engine, each beside a plain-version twin made
    from its tables (the twins run under the guard too): nothing raises,
    every post-flush scan runs and passes, the tables stay ``torch.equal`` to
    the twin's; the ``h2d`` / ``d2h`` counts of each. Then the in-place
    kernels on poisoned inputs (``check_kernel_aliasing``: K2 tile, K2
    levels, K3 both entries, K1 in place; exact), and a second process over
    this build directory, which must build 0 libraries (the warm budgets of
    ``tools/torch_build_budgets.json``); this process's first build is held
    to the cold budgets."""
    from repro_torch import knn
    from repro_torch.analysis import sanitize
    from repro_torch.core.errors import SanitizerError
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    out: dict = {"phase": "sanitize"}
    t_phase = time.perf_counter()

    planted = None
    probe = torch.ones(8, device=dev)
    try:
        with sanitize.no_transfers("probe"):
            probe.sum().item()  # an implicit sync: must raise
    except SanitizerError as e:
        planted = str(e).splitlines()[0]
    require(planted is not None and "`probe` path" in planted,
            "a sync planted under no_transfers did not raise SanitizerError")
    out["planted_sync"] = planted

    scans: list[str] = []
    scan_tables = sanitize.scan_tables

    def counted_scan(*args, **kwargs):
        scans.append(kwargs.get("context", ""))
        return scan_tables(*args, **kwargs)

    engines = state["sharded_engines"]
    rng = np.random.default_rng(41)
    os.environ["REPRO_SANITIZE"] = "1"
    sanitize.scan_tables = counted_scan
    try:
        for name, engine in (("scalar", engines["scalar"]), ("sharded", engines["sharded"])):
            ids, d = (x.cpu().numpy() for x in logical(engine))
            twin = knn.QueryEngine.from_tables(ids, d, engine.k, engine.objects, bn=engine.bn,
                                               device=dev, use_kernel=False)
            rec: dict = {"shards": getattr(engine, "num_shards", 1), "halo": engine.halo}
            if name == "scalar":
                nq = 1 << 20
                us = rng.integers(0, engine.n, size=nq).astype(np.int32)
                ks = rng.integers(1, engine.k + 1, size=nq).astype(np.int32)
                with sanitize.count_transfers() as t:
                    got = engine.query_batch(us, ks)
                want = twin.query_batch(us, ks)
                require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                        "guarded query answers differ from the plain twin's")
                rec["query"] = {"batch": nq, "h2d": t.h2d, "d2h": t.d2h}
            mset = set(engine.objects.tolist())
            staged = stage_traffic(knn, Both(engine, twin), mset, rng, 300, 180, 180)
            before = len(scans)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sanitize.count_transfers() as t:
                res = engine.flush_updates()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            require(twin.flush_updates() == res, f"{name}: guarded flush took another path")
            require(len(scans) == before + 2, f"{name}: a post-flush scan did not run")
            require(same_tables(engine, twin),
                    f"{name}: tables after a guarded flush differ from the plain twin's")
            rec["flush"] = {"staged": staged, "h2d": t.h2d, "d2h": t.d2h, "seconds": seconds,
                            **{key: res[key] for key in ("rows_purged", "rows_merged",
                                                         "repair_rounds", "frontier_rounds")}}
            out[name] = rec
            del twin
    finally:
        sanitize.scan_tables = scan_tables
        os.environ.pop("REPRO_SANITIZE", None)
    out["scans"] = scans
    state.pop("sharded_engines")

    out["aliasing_cells"] = sanitize.check_kernel_aliasing(device="cuda")

    # this process built the libraries cold; a second one over the same
    # directory builds none
    sanitize.assert_builds_within("flush_updates", cold=len(built))
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_COMPILE_CACHE=str(_build.build_dir()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _BUILD_PROBE], capture_output=True, text=True,
                          env=env, timeout=300)
    require(proc.returncode == 0, f"the build probe failed:\n{proc.stderr[-4000:]}")
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    for api in ("query_batch", "flush_updates", "sharded_query_batch", "sharded_flush_updates"):
        sanitize.assert_builds_within(api, warm=second["builds"][api])
    require(second["builds"]["build"] == second["builds"]["sharded_build"] == 0,
            f"the second process built kernel libraries: {second}")
    out["builds"] = {"first_process": built, "second_process": second["builds"],
                     "second_process_s": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# K5 and the recsys path
# ----------------------------------------------------------------------


def enqueue_ms(fn, reps: int = 20) -> float:
    """Median host time of one ``fn()`` in milliseconds, without a synchronize
    (the card idle before each call)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def retrieval_part_starts(n: int, parts: int) -> list[int]:
    """First column of each of K5's parts of a 16-byte-aligned float32 row
    (csrc/retrieval_topk.cu: ceil((n // 4) / parts) vectors of 4 a part)."""
    per = -(-(n // 4) // parts)
    return [min(n // 4, p * per) * 4 for p in range(parts)]


def check_retrieval_topk(dev, results) -> None:
    from repro_torch.configs import xdeepfm
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(16)
    n_cand, k = xdeepfm.RETRIEVAL_CANDIDATES, xdeepfm.RETRIEVAL_K
    neg_inf, pos_inf, nan = float("-inf"), float("inf"), float("nan")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def parts_of(s, kk):
        b, n = s.shape
        return ops.retrieval_plan(b, n, kk, ops.retrieval_slots(dev, s.dtype, kk))

    cases = []

    def held(s, kk, what):
        before = ops.LAUNCHES["retrieval_topk"]
        got = ops.retrieval_topk(s, kk)
        launched = ops.LAUNCHES["retrieval_topk"] - before
        want = ref.retrieval_topk_ref(s, kk)
        torch.cuda.synchronize()
        require(got[0].dtype == torch.int32 and got[1].dtype == s.dtype
                and tuple(got[0].shape) == (s.shape[0], kk), f"retrieval_topk {what}: bad output")
        bad_ids = int((got[0] != want[0]).sum())
        bad_s = int(((got[1] != want[1]) | (got[1].signbit() != want[1].signbit())).sum())
        require(bad_ids == 0 and bad_s == 0 and torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1]),
                f"retrieval_topk differs from its plain version {what}: {bad_ids} of "
                f"{want[0].numel()} ids and {bad_s} scores differ")
        require(launched == 1, f"retrieval_topk {what}: {launched} launches for one call")
        cases.append({"case": what, "shape": list(s.shape) + [kk], "parts": parts_of(s, kk)})
        return got, want

    # what the one-launch design can get wrong: the arrival counters across
    # calls, the parts' merge, the edges of a part, the alignment of a row
    s = randn(4, 200_000)
    held(s, k, "back to back, first call")
    held(s, k, "back to back, same inputs")
    held(randn(4, 200_000), k, "back to back, other inputs")
    up = torch.arange(n_cand, dtype=torch.float32, device=dev)[None]
    held(up, k, "ascending at (1, 10^6)")
    held(up.flip(1), k, "descending at (1, 10^6)")
    held(torch.full((2, n_cand), 0.5, device=dev), k, "all scores equal")
    s = randn(4, n_cand)
    s[0, ::97] = nan
    s[0, 5::20011] = pos_inf  # 50 +inf, fewer than k
    s[1, ::50] = nan
    s[1, 3::3001] = pos_inf  # 334 +inf, more than k
    s[2] = -0.0
    s[2, ::7] = 0.0
    s[2, 1::13] = nan
    s[3, ::5] = neg_inf
    s[3, 1::11] = nan
    s[3, 2::101] = pos_inf
    s[3, 3::17] = -0.0
    held(s, k, "with NaN, +inf and -0.0")
    s = randn(3, 1_000_003)
    held(s, k, "at N = 1,000,003 (rows not 16-byte aligned)")
    held(s.to(torch.bfloat16), k, "at N = 1,000,003 in bfloat16")
    big = randn(2 * n_cand + 1)
    held(big[1:].view(2, n_cand), k, "at a storage offset of 1")
    del big
    parts = parts_of(up, k)
    starts = retrieval_part_starts(n_cand, parts) + [n_cand]
    j = parts // 2
    s = randn(1, n_cand)
    inside = starts[j] + torch.randperm(starts[j + 1] - starts[j], generator=gen,
                                        device=dev)[: 2 * k]
    s[0, inside] += 100.0
    held(s, k, f"with the k best in one part (part {j} of {parts})")
    edge = starts[j + 1]
    s = randn(1, n_cand)
    far = torch.randperm(edge - 1, generator=gen, device=dev)[: k - 1]
    s[0, far] = 10.0 + torch.rand(k - 1, generator=gen, device=dev)
    s[0, edge - 1] = 5.0
    s[0, edge] = 5.0
    held(s, k, f"with the k-th key at the end of part {j} of {parts}, the next at the start "
               f"of part {j + 1}")
    s1024 = randn(1, n_cand)
    held(s1024, 1024, "at k = 1024, (1, 10^6)")
    held(randn(70_000, 64), 8, "at B = 70,000, N = 64, k = 8")
    kk = 16
    slots = ops.retrieval_slots(dev, torch.float32, kk)
    n_max = slots * ops.RETRIEVAL_MIN_PART
    p_max = ops.retrieval_plan(1, n_max, kk, slots)
    require(p_max == slots, f"retrieval_plan at (1, {n_max}, {kk}): {p_max} parts, not {slots}")
    held(randn(1, n_max), kk, f"at the plan's largest P = {p_max}")
    # the cases the first design was checked on
    for b, n, kk in ((1, 1024, 5), (8, 10000, 16), (3, 4096, 100)):  # the JAX test's shapes
        held(randn(b, n), kk, f"at {(b, n, kk)}")
    held(torch.round(randn(4, n_cand) * 10) / 10, k, "with scores rounded to 0.1")
    s = randn(4, 300_000)
    s[0, ::3] = neg_inf
    s[1] = neg_inf
    s[2, 50:] = neg_inf  # fewer finite scores than k
    held(s, k, "with -inf scores")
    held(randn(3, 50), 64, "at N = 50 < k = 64")
    held(randn(8, n_cand).to(torch.bfloat16), k, "in bfloat16")
    held(randn(2, 100_000), 1024, "at k = 1024")
    s = randn(512, n_cand)
    held(s, k, "at (512, 10^6)")
    at_512 = {"ms": cuda_ms(lambda: ops.retrieval_topk(s, k)),
              "plain_ms": cuda_ms(lambda: ref.retrieval_topk_ref(s, k), reps=3),
              "library_ms": cuda_ms(lambda: torch.topk(s, k)),
              "bound_ms": bound(512 * (n_cand * 4 + k * 8), 512 * n_cand)[0],
              "parts": parts_of(s, k)}
    del s
    ms_ascending = cuda_ms(lambda: ops.retrieval_topk(up, k), reps=20)
    ms_k1024 = cuda_ms(lambda: ops.retrieval_topk(s1024, 1024), reps=20)
    # the retrieval_cand shape, timed
    s = randn(1, n_cand)
    got, want = held(s, k, "at (1, 10^6)")
    err = max_abs_err(got[1], want[1])
    ms = cuda_ms(lambda: ops.retrieval_topk(s, k), reps=20)
    plain_ms = cuda_ms(lambda: ref.retrieval_topk_ref(s, k))
    library_ms = cuda_ms(lambda: torch.topk(s, k), reps=20)
    bms, by = bound(n_cand * 4 + k * 8, n_cand)
    results["retrieval_topk"] = {
        "shape": {"B": 1, "N": n_cand, "k": k}, "parts": parts_of(s, k), "max_abs_err": err,
        "ms": ms, "enqueue_ms": enqueue_ms(lambda: ops.retrieval_topk(s, k)),
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        "launches_per_call": 1, "at_B512": at_512,
        "ms_ascending": ms_ascending, "ms_at_k1024": ms_k1024,
        "parts_at_k1024": parts_of(s1024, 1024), "slots": slots, "cases": len(cases),
        "case_parts": {c["case"]: c["parts"] for c in cases},
    }


def recsys(dev) -> dict:
    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rc

    cfg = xdeepfm.make_config()
    out: dict = {"phase": "recsys", "config": cfg.name}
    t0 = time.perf_counter()
    params = rc.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["table_bytes"] = params["tables"].numel() * params["tables"].element_size()

    def ids_of(b):
        stream = RecsysStream(n_sparse=cfg.n_sparse, bag=cfg.bag_size, rows=cfg.table_rows,
                              batch=b, multi_hot_fields=cfg.multi_hot_fields)
        return {"sparse_ids": torch.from_numpy(stream.batch_at(0)["sparse_ids"]).to(dev)}

    logits = {}
    for cell, b in (("serve_p99", xdeepfm.SERVE_P99_BATCH),
                    ("serve_bulk", xdeepfm.SERVE_BULK_BATCH)):
        batch = ids_of(b)
        logits[cell] = rc.forward(params, batch, cfg, device=dev)
        torch.cuda.synchronize()
        require(tuple(logits[cell].shape) == (b,) and bool(torch.isfinite(logits[cell]).all()),
                f"xdeepfm forward at B = {b}: bad logits")
        ms = cuda_ms(lambda: rc.forward(params, batch, cfg, device=dev), reps=3)
        out[cell] = {"batch": b, "ms": ms, "rows_per_s": b / ms * 1e3}
    # the bulk batch goes through the CIN in row chunks: its first rows alone
    # must give the same logits, and those must agree with float64
    bulk = ids_of(xdeepfm.SERVE_BULK_BATCH)
    head = {"sparse_ids": bulk["sparse_ids"][:512]}
    alone = rc.forward(params, head, cfg, device=dev)
    p64 = {key: ([{kk: t.double() for kk, t in layer.items()} for layer in val]
                 if key == "mlp" else [t.double() for t in val] if key == "cin"
                 else val.double()) for key, val in params.items()}
    exact = rc.forward(p64, head, cfg, device=dev)
    del p64
    torch.cuda.empty_cache()
    err64 = float((alone.double() - exact).abs().max())
    err_chunks = float((logits["serve_bulk"][:512] - alone).abs().max())
    out.update(float64_max_abs_err=err64, chunked_max_abs_err=err_chunks,
               logit_scale=float(exact.abs().max()))
    require(err64 <= 1e-5 + 1e-4 * out["logit_scale"], f"xdeepfm forward vs float64: {err64}")
    require(err_chunks <= 1e-5 + 1e-4 * out["logit_scale"],
            f"xdeepfm forward, bulk rows vs alone: {err_chunks}")

    # retrieval_cand: one query against 10^6 items with K5
    query = {"sparse_ids": ids_of(1)["sparse_ids"], "n_candidates": xdeepfm.RETRIEVAL_CANDIDATES}
    k = xdeepfm.RETRIEVAL_K
    ops.reset_launches()  # ---- the retrieval's launches are counted from here ----
    got = rc.retrieval_score(params, query, cfg, k=k, device=dev)
    torch.cuda.synchronize()
    out["launches"] = ops.launches()  # ---- read right after it ----
    require(out["launches"]["retrieval_topk"] == 1,
            f"retrieval_score launched retrieval_topk {out['launches']['retrieval_topk']} times, "
            "not once")
    want = rc.retrieval_score(params, query, cfg, k=k, device=dev, use_kernel=False)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "retrieval_score with the kernel differs from the plain version")
    require(bool((got[0] >= 0).all()) and bool((got[1][0, :-1] >= got[1][0, 1:]).all()),
            "retrieval_score: ids missing or scores out of order")
    out["retrieval"] = {
        "N": xdeepfm.RETRIEVAL_CANDIDATES, "k": k, "top_ids": got[0][0, :8].tolist(),
        "ms": cuda_ms(lambda: rc.retrieval_score(params, query, cfg, k=k, device=dev), reps=10),
        "plain_ms": cuda_ms(lambda: rc.retrieval_score(params, query, cfg, k=k, device=dev,
                                                       use_kernel=False)),
        "profile": profiled_retrieval(params, query, cfg, k, dev),
    }
    del params
    torch.cuda.empty_cache()
    ex, _ = run_cli("repro_torch.examples.retrieval_recsys",
                    ["--candidates", str(xdeepfm.RETRIEVAL_CANDIDATES), "--k", str(k)], 300,
                    phase="recsys_example")
    require(ex["agrees"] is True and ex["path"] == "CUDA kernel",
            f"retrieval example: {ex['path']} agrees {ex['agrees']}")
    require(ex["launches"]["retrieval_topk"] == 2,
            f"retrieval example: {ex['launches']['retrieval_topk']} retrieval_topk launches for "
            "two calls")
    return out


def device_kernels(prof) -> list[dict]:
    """The kernels of a ``torch.profiler`` run with their device time and
    calls, the longest first."""
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and us > 0:
            kernels.append({"kernel": ev.key[:100], "device_us": us, "calls": ev.count})
    kernels.sort(key=lambda row: -row["device_us"])
    return kernels


def profiled_retrieval(params, query, cfg, k: int, dev) -> dict:
    """Where one ``retrieval_score`` call spends its time (a measurement, not
    a path): its host time to the end of its work, the device time of each
    kernel under ``torch.profiler``, and CUDA events around its three steps
    (embedding gathers, the scoring product, K5) run one after another."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rc

    def call():
        return rc.retrieval_score(params, query, cfg, k=k, device=dev)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    steps = {"gathers": [], "scoring_product": [], "retrieval_topk": []}
    for _ in range(10):
        marks[0].record()
        emb, _ = rc._embed_fields(params, rc._sparse_ids(params, query, dev))
        q = emb.sum(dim=1)
        marks[1].record()
        scores = q @ params["tables"][0, : query["n_candidates"]].T.to(q.dtype)
        marks[2].record()
        ops.retrieval_topk(scores, k)
        marks[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(steps):
            steps[name].append(marks[i].elapsed_time(marks[i + 1]))
    return {"host_ms": host_ms, "device_us_total": sum(r["device_us"] for r in kernels),
            "kernels": kernels[:12],
            "event_ms": {name: statistics.median(v) for name, v in steps.items()}}


# ----------------------------------------------------------------------
# K6 and the LM path
# ----------------------------------------------------------------------


def attn_pairs(s: int, t: int, causal: bool) -> int:
    """Unmasked (query, key) pairs: j <= i under the causal mask."""
    if not causal:
        return s * t
    full = min(s, t)  # rows 0..full-1 see i+1 keys, the rest all t
    return full * (full + 1) // 2 + (s - full) * t


def kernel_sass(name: str, function: str) -> dict | None:
    """What ``cuobjdump`` shows of one kernel function in its built library:
    registers, stack, local memory (spills), and the count of each of a few
    SASS instructions. None where the toolkit has no ``cuobjdump``."""
    import re

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    lib = str(_build._lib_path(name))
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                           check=True).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out: dict = {"function": function}
    found = re.search(r"Function [^:\n]*" + function + r"[^:\n]*:\s*\n\s*REG:(\d+) STACK:(\d+) "
                      r"SHARED:(\d+) LOCAL:(\d+)", usage)
    if found:
        out.update(zip(("registers", "stack", "static_shared", "local"),
                       map(int, found.groups())))
    body = next((part for part in sass.split("Function : ")[1:]
                 if function in part.split("\n")[0]), "")
    for op in ("HGMMA", "UTMALDG", "LDGSTS", "FMNMX", "FADD", "REDUX", "LDL", "STL", "MUFU.EX2"):
        out[op] = len(re.findall(r"\b" + re.escape(op) + r"[.\s]", body))
    return out


def attn_held(got: torch.Tensor, want: torch.Tensor, route: str) -> dict:
    """K6's output on ``route`` against its plain version under each bound of
    its dtype (``"tol"``: ATTN_TOL; bf16 also ``"ulps"``: the route's
    ATTN_ULPS_BF16): whether |got - want| <= atol + rtol |want| everywhere,
    the count of entries outside it, and the largest
    |got - want| / (atol + rtol |want|)."""
    bounds = {"tol": ATTN_TOL[want.dtype]}
    if want.dtype == torch.bfloat16:
        bounds["ulps"] = ATTN_ULPS_BF16[route]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {}
    for name, (atol, rtol) in bounds.items():
        limit = atol + rtol * w.abs()
        inside = diff <= limit
        out[name] = {"atol": atol, "rtol": rtol, "ok": bool(inside.all()),
                     "outside": int(inside.numel() - inside.sum()),
                     "ratio": float((diff / limit).max()) if diff.numel() else 0.0}
    return out


def attn_plain(q, k, v, *, causal: bool) -> torch.Tensor:
    """K6's plain version at the kv tile of the route K6 takes for these
    inputs (ATTN_KV_TILE)."""
    from repro_torch.kernels import ops, ref

    route = ops.flash_attention_route(q.dtype, q.shape[3])[0]
    return ref.flash_attention_ref(q, k, v, causal=causal, kv_block=ATTN_KV_TILE[route])


def check_flash_attention(dev, results) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    checked = []

    def qkv(b, s, t, h, hkv, d, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]

    def held(case, causal, what):
        got = ops.flash_attention(*case, causal=causal)
        want = attn_plain(*case, causal=causal)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(got.dtype == case[0].dtype and got.shape == case[0].shape,
                f"flash_attention {what}: bad output")
        route = ops.flash_attention_route(case[0].dtype, case[0].shape[3])[0]
        bounds = attn_held(got, want, route)
        for name, b in bounds.items():
            require(b["ok"], f"flash_attention differs from its plain version {what}: "
                             f"max_abs_err {err}, {b['ratio']} times the {name} bound")
        checked.append({"case": what, "route": route, "max_abs_err": err,
                        **{name: {key: b[key] for key in ("atol", "rtol", "ratio")}
                           for name, b in bounds.items()}})
        return err

    def sdpa(case, causal):
        qt, kt, vt = (x.transpose(1, 2) for x in case)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)

    flops_32k = 4.0 * 16 * 128 * attn_pairs(32768, 32768, True)
    case = qkv(1, 32768, 32768, 16, 2, 128, bf16)  # prefill_32k, one sequence
    held(case, True, "(1, 32768, 16/2, 128) causal bf16")
    ms_32k = cuda_ms(lambda: ops.flash_attention(*case, causal=True), reps=5)
    library_32k = cuda_ms(sdpa(case, True), reps=5)
    plain_32k = cuda_ms(lambda: ref.flash_attention_ref(*case, causal=True), reps=1)
    del case
    f32 = qkv(4, 2048, 2048, 16, 2, 128, torch.float32)
    held(f32, True, "(4, 2048, 16/2, 128) causal f32")
    ms_f32 = cuda_ms(lambda: ops.flash_attention(*f32, causal=True), reps=5)
    del f32
    held(qkv(2, 700, 1300, 16, 2, 128, torch.float32), False, "(2, 700/1300, 16/2) non-causal f32")
    held(qkv(1, 513, 513, 8, 8, 128, torch.float32), True, "(1, 513, 8/8, 128) causal f32")
    # the bf16 route at its edges: lengths no 128-row tile divides, T > S and
    # S > T, H = Hkv, fewer blocks than SMs, no kv rows, one query row
    held(qkv(2, 1300, 700, 16, 2, 128, bf16), False, "(2, 1300/700, 16/2) non-causal bf16")
    held(qkv(2, 700, 1300, 16, 2, 128, bf16), False, "(2, 700/1300, 16/2) non-causal bf16")
    held(qkv(2, 1300, 700, 16, 2, 128, bf16), True, "(2, 1300/700, 16/2) causal bf16")
    held(qkv(3, 1000, 1000, 16, 2, 128, bf16), True, "(3, 1000, 16/2) causal bf16")
    held(qkv(1, 513, 513, 8, 8, 128, bf16), True, "(1, 513, 8/8, 128) causal bf16")
    held(qkv(1, 128, 128, 2, 1, 128, bf16), True, "(1, 128, 2/1, 128) causal bf16, 2 blocks")
    held(qkv(2, 5, 0, 2, 1, 128, bf16), False, "(2, 5/0, 2/1) bf16, no kv rows")
    held(qkv(1, 1, 300, 4, 2, 128, bf16), False, "(1, 1/300, 4/2) non-causal bf16")
    # every other head dim K6 takes, both dtypes (the CUDA-core route): a
    # causal grid of 5 query tiles, uneven non-causal lengths with H = Hkv, one
    # query row; then each dtype's time at the prefill's layout beside SDPA
    # (D = 64 bf16: granite-moe's head; D = 32 float32: train_lm's lm-15m)
    for hd in (8, 16, 32, 64):
        for dt in (torch.float32, bf16):
            name = f"D={hd} {str(dt).split('.')[-1]}"
            held(qkv(2, 300, 300, 8, 2, hd, dt), True, f"(2, 300, 8/2) causal {name}")
            held(qkv(1, 130, 270, 4, 4, hd, dt), False, f"(1, 130/270, 4/4) non-causal {name}")
            held(qkv(2, 1, 65, 4, 2, hd, dt), False, f"(2, 1/65, 4/2) non-causal {name}")
    head_dims = {}
    for hd, dt in ((64, bf16), (32, torch.float32), (64, torch.float32), (32, bf16)):
        case = qkv(4, 2048, 2048, 16, 2, hd, dt)
        hd_flops = 4.0 * 4 * 16 * hd * attn_pairs(2048, 2048, True)
        hd_bytes = case[0].element_size() * (2 * case[0].numel() + 2 * case[1].numel())
        hd_ms = cuda_ms(lambda: ops.flash_attention(*case, causal=True), reps=10)
        head_dims[f"D={hd} {str(dt).split('.')[-1]}"] = {
            "shape": "(4, 2048, 16/2) causal",
            "route": ops.flash_attention_route(dt, hd)[0],
            "max_abs_err": held(case, True, f"(4, 2048, 16/2, {hd}) causal {dt}"),
            "ms": hd_ms, "library_ms": cuda_ms(sdpa(case, True), reps=10),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(*case, causal=True), reps=2),
            "bound_ms": bound(hd_bytes, hd_flops, BF16_TENSOR_OPS_PER_S if dt == bf16
                              else F32_OPS_PER_S)[0],
            "tflops": hd_flops / hd_ms / 1e9}
        del case
    # the prefill's own shape (qwen2.5-3b, batch 4, prompt 2048), timed
    b, s, h, hkv, d = 4, 2048, 16, 2, 128
    case = qkv(b, s, s, h, hkv, d, bf16)
    err = held(case, True, "(4, 2048, 16/2, 128) causal bf16")
    ms = cuda_ms(lambda: ops.flash_attention(*case, causal=True), reps=20)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(*case, causal=True))
    library_ms = cuda_ms(sdpa(case, True), reps=20)
    flops = 4.0 * b * h * d * attn_pairs(s, s, True)
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * hkv * d)
    bms, by = bound(nbytes, flops, BF16_TENSOR_OPS_PER_S)
    # the newer LMs' head layouts at their prefill (batch 4, prompt 2048):
    # granite-moe on the FMA route, and wgmma at GQA groups of 5, 6 and 8
    head_layouts, t_layouts = {}, time.perf_counter()
    for model, (h, hkv, hd) in HEAD_LAYOUTS.items():
        case = qkv(4, 2048, 2048, h, hkv, hd, bf16)
        lay_flops = 4.0 * 4 * h * hd * attn_pairs(2048, 2048, True)
        lay_bytes = 2 * (2 * case[0].numel() + 2 * case[1].numel())
        what = f"(4, 2048, {h}/{hkv}, {hd}) causal bf16"
        lay_err = held(case, True, f"{what}, {model}")
        lay_ms = cuda_ms(lambda: ops.flash_attention(*case, causal=True), reps=10)
        lay_bound, lay_by = bound(lay_bytes, lay_flops, BF16_TENSOR_OPS_PER_S)
        head_layouts[model] = {
            "shape": what, "route": ops.flash_attention_route(bf16, hd)[0],
            "max_abs_err": lay_err, "ms": lay_ms, "library_ms": cuda_ms(sdpa(case, True), reps=10),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(*case, causal=True), reps=1),
            "bound_ms": lay_bound, "bound_by": lay_by, "tflops": lay_flops / lay_ms / 1e9}
        del case
    head_layouts_s = time.perf_counter() - t_layouts
    sass = kernel_sass("flash_attention", "attention_wgmma")
    if sass is not None:  # the bf16 route issues wgmma and loads its tiles by TMA
        require(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
                f"flash_attention's bf16 kernel has no wgmma or no TMA load: {sass}")
    results["flash_attention"] = {
        "shape": {"B": b, "S": s, "T": s, "H": h, "Hkv": hkv, "D": d, "causal": True,
                  "dtype": "bfloat16"},
        "dtype_routes": {f"{str(dt).split('.')[-1]} D={hd}": ops.flash_attention_route(dt, hd)[0]
                         for dt in (bf16, torch.float32) for hd in ops.ATTN_HEAD_DIMS},
        "head_dims": head_dims, "head_layouts": head_layouts, "head_layouts_s": head_layouts_s,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": library_ms, "tflops": flops / ms / 1e9, "checked": checked,
        "ms_f32": ms_f32, "tflops_f32": flops / ms_f32 / 1e9,
        "ms_32k": ms_32k, "tflops_32k": flops_32k / ms_32k / 1e9, "plain_ms_32k": plain_32k,
        "library_ms_32k": library_32k,
        "bound_ms_32k": bound(0, flops_32k, BF16_TENSOR_OPS_PER_S)[0],
        "sass_bf16": sass,
    }


def lm(dev) -> dict:
    from repro_torch.configs import qwen2_5_3b

    out: dict = {"phase": "lm"}
    served, _ = run_cli("repro_torch.launch.serve",
                        ["--arch", "qwen2.5-3b", "--batch", "4", "--prompt-len", "2048",
                         "--gen", "32"], 600, phase="lm_serve")
    cfg = qwen2_5_3b.make_config()
    require(served["params"] == cfg.param_count() and served["model"] == cfg.name,
            f"serve ran {served['model']}, not the full {cfg.name}")
    require(served["launches"]["flash_attention"] == cfg.n_layers,
            f"serve's prefill launched flash_attention {served['launches']['flash_attention']} "
            f"times, not once per layer ({cfg.n_layers})")
    out["serve"] = {key: served[key] for key in
                    ("prefill_ms", "decode_ms", "decode_tok_per_s", "launches")}

    # the twins: full width, two layers, in float32 (K6's CUDA-core route) and
    # in bfloat16 (its wgmma route); each prefills with K6 and with the plain
    # attention, then takes 16 greedy decode steps from each
    for dtype, (atol, rtol) in LOGIT_TOL.items():
        out[f"twin_{str(dtype).split('.')[-1]}"] = twin(cfg, dtype, atol, rtol, dev)
    return out


def library_attention(q, k, v, *, causal, use_kernel=True):
    """``nn.attention``'s function by ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         is_causal=causal, enable_gqa=True)
    return out.transpose(1, 2).contiguous()


def twin_model(cfg, dtype, dev):
    """The twin: ``cfg`` at full width cut to two layers in ``dtype``, its
    weights from seed 0, and four 2,048-token prompts from seed 1."""
    from repro_torch.models import transformer as tr

    name = f"{cfg.name}-2l-{str(dtype).split('.')[-1]}"
    model = dataclasses.replace(cfg, name=name, n_layers=2, param_dtype=dtype)
    params = tr.init_params(model, seed=0, device=dev)
    prompts = torch.randint(0, model.vocab, (4, 2048), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    return model, params, prompts


class RoutePin:
    """Pins a MoE model's routing across two runs: ``record()`` keeps what
    each ``_moe_route`` call returns; ``replay()`` hands those back call by
    call, and keeps for each call, per token, whether its own routing would
    choose other experts and the gap between its k-th and (k+1)-th
    probabilities. Outside a MoE model both are no-ops."""

    def __init__(self, moe: bool):
        self.moe, self.tape, self.notes = moe, [], []

    @contextlib.contextmanager
    def _patched(self, route):
        from repro_torch.models import transformer as tr

        if not self.moe:
            yield
            return
        inner, tr._moe_route = tr._moe_route, route
        try:
            yield
        finally:
            tr._moe_route = inner

    def record(self):
        from repro_torch.models import transformer as tr

        inner = tr._moe_route

        def route(lp, x2d, cfg):
            self.tape.append(inner(lp, x2d, cfg))
            return self.tape[-1]
        return self._patched(route)

    def replay(self):
        from repro_torch.models import transformer as tr

        inner = tr._moe_route

        def route(lp, x2d, cfg):
            gates, eidx = self.tape.pop(0)
            _, own = inner(lp, x2d, cfg)
            k = cfg.moe_top_k
            probs = torch.sort(torch.softmax(x2d.to(torch.float32) @ lp["router"]["w"], dim=-1),
                               dim=-1, descending=True).values
            other = (torch.sort(own, dim=-1).values != torch.sort(eidx, dim=-1).values).any(-1)
            self.notes.append((other, probs[:, k - 1] - probs[:, k]))
            return gates, eidx
        return self._patched(route)

    def widest(self, rows=None) -> tuple[int, float]:
        """(tokens routed apart, the widest gap among them) over the notes
        since the last call; ``rows`` (B,) bool limits a decode step's
        tokens to those rows."""
        n, widest = 0, 0.0
        for other, gap in self.notes:
            if rows is not None:
                other = other & rows
            n += int(other.sum())
            if bool(other.any()):
                widest = max(widest, float(gap[other].max()))
        self.notes = []
        return n, widest


def twin(cfg, dtype, atol: float, rtol: float, dev) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models import nn as tnn
    from repro_torch.models import transformer as tr

    model, params, prompts = twin_model(cfg, dtype, dev)
    name = model.name
    steps = 16
    pin = RoutePin(model.is_moe)
    route_gap = TWIN_ROUTE_GAP[dtype]
    with pin.record():
        l_p, c_p = tr.prefill(params, prompts, model, 2048 + steps, device=dev, use_kernel=False)
    plain_routes = list(pin.tape)
    ops.reset_launches()  # ---- the twin's launches are counted from here ----
    with pin.replay():
        l_k, c_k = tr.prefill(params, prompts, model, 2048 + steps, device=dev)
    torch.cuda.synchronize()
    launches = ops.launches()  # ---- read right after its prefill ----
    require(launches["flash_attention"] == model.n_layers, f"{name} prefill: {launches}")
    routed_apart, widest = pin.widest()
    err = max_abs_err(l_k, l_p)
    # the yardstick: the library's attention in place of both, never in the port
    attention = tnn.attention
    tnn.attention = library_attention
    pin.tape = plain_routes
    try:
        with pin.replay():
            l_lib, _ = tr.prefill(params, prompts, model, 2048 + steps, device=dev)
    finally:
        tnn.attention = attention
    pin.notes = []
    err_library = max_abs_err(l_lib, l_p)
    del l_lib
    require(bool(torch.isfinite(l_k).all()) and tuple(l_k.shape) == (4, model.vocab),
            f"{name} prefill: bad logits")
    require(bool(((l_k.float() - l_p.float()).abs() <= atol + rtol * l_p.float().abs()).all()),
            f"{name} prefill logits, kernel vs plain attention: max_abs_err {err}")
    # greedy tokens: equal, except that a near-tie (top two plain logits within
    # TIE_TOL) may legitimately send one row down another path
    tie_atol, tie_rtol = TIE_TOL[dtype]
    tok_k, tok_p = torch.argmax(l_k, -1), torch.argmax(l_p, -1)
    live = torch.ones(4, dtype=torch.bool, device=dev)
    diverged = []
    for step in range(steps + 1):
        top2 = torch.topk(l_p.float(), 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= tie_atol + tie_rtol * top2[:, 0].abs()
        differ = live & (tok_k != tok_p)
        require(bool((tie | ~differ).all()),
                f"{name}: greedy token of step {step} differs without a near-tie")
        for row in torch.nonzero(differ).flatten().tolist():
            diverged.append({"row": row, "step": step})
        live &= ~differ
        if step == steps:
            break
        with pin.record():
            l_p, c_p = tr.decode_step(params, c_p, tok_p, model)
        with pin.replay():
            l_k, c_k = tr.decode_step(params, c_k, tok_k, model)
        n, gap = pin.widest(live)
        routed_apart, widest = routed_apart + n, max(widest, gap)
        tok_k, tok_p = torch.argmax(l_k, -1), torch.argmax(l_p, -1)
    require(route_gap is None or widest <= route_gap,
            f"{name}: a token's own routing with K6 chose other experts at a probability gap "
            f"of {widest}, over {route_gap}")
    return {"launches": launches, "logits_max_abs_err": err, "atol": atol, "rtol": rtol,
            "tie_atol": tie_atol, "tie_rtol": tie_rtol,
            "library_logits_max_abs_err": err_library,
            "greedy_steps": steps, "diverged": diverged,
            "rows_equal_throughout": int(live.sum()),
            **({"routing_pinned": True, "tokens_routed_apart": routed_apart,
                "widest_gap_routed_apart": widest, "route_gap": route_gap}
               if model.is_moe else {})}


# ----------------------------------------------------------------------
# phase: the newer LM configurations (MoE and the wider heads)
# ----------------------------------------------------------------------


def prefill_split(cfg, dev) -> dict:
    """One warm prefill of ``cfg`` (full, batch 4 x 2,048, weights from seed
    0) with CUDA events around each K6 call (``nn.attention``) and each MoE
    FFN: the device milliseconds of each beside the prefill's own (events
    around it, and the host clock to its synchronize)."""
    from repro_torch.models import nn as tnn
    from repro_torch.models import transformer as tr

    params = tr.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab, (4, 2048), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    tr.prefill(params, prompts, cfg, 2048, device=dev)  # warm
    marks = {"attention": [], "moe_ffn": []}
    inner = {"attention": tnn.attention, "moe_ffn": tr._moe_ffn}

    def timed(name):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            result = inner[name](*args, **kwargs)
            b.record()
            marks[name].append((a, b))
            return result
        return call

    tnn.attention, tr._moe_ffn = timed("attention"), timed("moe_ffn")
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        tr.prefill(params, prompts, cfg, 2048, device=dev)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tnn.attention, tr._moe_ffn = inner["attention"], inner["moe_ffn"]
    device_ms = start.elapsed_time(end)
    out = {"prefill_ms": host_ms, "prefill_events_ms": device_ms}
    for name, pairs in marks.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        out[name] = {"calls": len(pairs), "ms": ms, "share": ms / device_ms}
    del params
    torch.cuda.empty_cache()
    return out


def moe_on_card(cfg, dev) -> dict:
    """One full-width layer of the MoE ``cfg`` over MOE_TOKENS tokens, in
    float32 on the card and on the CPU: routing equal but at near-ties
    (ROUTE_GAP); the card's routing through dispatch, experts and combine on
    both sides within MOE_TOL; ``_moe_ffn`` twice on the card bit for bit
    (float32 and bfloat16) and under the sync guard."""
    from repro_torch.analysis import sanitize
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map

    model = dataclasses.replace(cfg, n_layers=1, param_dtype=torch.float32)
    lp = tr.init_params(model, seed=3, device=dev)["layers"][0]
    x = torch.randn((MOE_TOKENS, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    lp16 = tr.init_params(dataclasses.replace(cfg, n_layers=1), seed=3, device=dev)["layers"][0]
    x16 = x.to(torch.bfloat16)
    with sanitize.no_transfers("moe_ffn"):
        y, y_again = tr._moe_ffn(lp, x, model), tr._moe_ffn(lp, x, model)
        y16, y16_again = tr._moe_ffn(lp16, x16, cfg), tr._moe_ffn(lp16, x16, cfg)
    torch.cuda.synchronize()
    require(torch.equal(y, y_again) and torch.equal(y16, y16_again),
            "_moe_ffn twice on the card: outputs differ")
    ms_bf16 = cuda_ms(lambda: tr._moe_ffn(lp16, x16, cfg), reps=10)

    k = cfg.moe_top_k
    gates, eidx = tr._moe_route(lp, x, model)
    lp_cpu, x_cpu = tree_map(lambda t: t.cpu(), lp), x.cpu()
    gates_c, eidx_c = tr._moe_route(lp_cpu, x_cpu, model)
    probs = torch.sort(torch.softmax(x_cpu @ lp_cpu["router"]["w"], dim=-1), dim=-1,
                       descending=True).values
    gap = probs[:, k - 1] - probs[:, k]
    same_set = (torch.sort(eidx.cpu(), dim=-1).values == torch.sort(eidx_c, dim=-1).values).all(-1)
    require(bool((same_set | (gap <= ROUTE_GAP)).all()),
            f"MoE routing on the card differs from the CPU's at a gap over {ROUTE_GAP}")
    same = (eidx.cpu() == eidx_c).all(-1)
    gate_err = max_abs_err(gates.cpu()[same], gates_c[same])

    t0 = time.perf_counter()
    y_cpu = tr._moe_dispatch(lp_cpu, x_cpu, gates.cpu(), eidx.cpu(), model)
    cpu_s = time.perf_counter() - t0
    y_card = tr._moe_dispatch(lp, x, gates, eidx, model)
    require(torch.equal(y_card, y), "_moe_ffn against route + dispatch on the card")
    err = max_abs_err(y_card.cpu(), y_cpu)
    atol, rtol = MOE_TOL
    require(bool(((y_card.cpu() - y_cpu).abs() <= atol + rtol * y_cpu.abs()).all()),
            f"MoE dispatch/experts/combine, card against CPU: max_abs_err {err}")
    cap = int(np.ceil(MOE_TOKENS * k / cfg.n_experts * cfg.capacity_factor))
    counts = torch.bincount(eidx.reshape(-1).cpu(), minlength=cfg.n_experts)
    return {"tokens": MOE_TOKENS, "experts": cfg.n_experts, "top_k": k, "capacity": cap,
            "dropped": int((counts - cap).clamp(min=0).sum()),
            "routing_rows_differ": int((~same_set).sum()), "route_gap": ROUTE_GAP,
            "smallest_gap": float(gap.min()), "gate_max_abs_err": gate_err,
            "max_abs_err": err, "atol": atol, "rtol": rtol, "out_scale": float(y_cpu.abs().max()),
            "bitwise_repeat": True, "sync_guard": "clean", "ms_bf16": ms_bf16,
            "cpu_dispatch_s": cpu_s}


def lm_archs(dev, results) -> dict:
    """granite-moe-1b-a400m and internlm2-20b served in full in subprocesses;
    llama4-scout and qwen1.5-110b served in process at full width and reduced
    depth; granite's prefill split; its two-layer twins; its MoE layer on the
    card against the CPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr

    out: dict = {"phase": "lm_archs"}
    t_phase = time.perf_counter()
    k6 = results["flash_attention"]["head_layouts"]
    for arch in ("granite-moe-1b-a400m", "internlm2-20b"):
        served, _ = run_cli("repro_torch.launch.serve",
                            ["--arch", arch, "--batch", "4", "--prompt-len", "2048", "--gen", "32"],
                            600, phase="lm_archs_serve")
        cfg = get_arch(arch).make_config()
        require(served["params"] == cfg.param_count() and served["model"] == cfg.name,
                f"serve ran {served['model']}, not the full {cfg.name}")
        n_k6 = served["launches"]["flash_attention"]
        require(n_k6 == cfg.n_layers,
                f"{arch}: serve's prefill launched flash_attention {n_k6} times, not "
                f"once per layer ({cfg.n_layers})")
        out[arch] = {"layers": f"{cfg.n_layers} of {cfg.n_layers}", "params": cfg.param_count(),
                     **{key: served[key] for key in ("prefill_ms", "decode_ms",
                                                      "decode_tok_per_s", "launches")},
                     "k6_ms_a_launch": k6[arch]["ms"],
                     "k6_share_by_kernel_check": n_k6 * k6[arch]["ms"] / served["prefill_ms"]}
    granite = get_arch("granite-moe-1b-a400m").make_config()
    out["granite-moe-1b-a400m"]["prefill_split"] = prefill_split(granite, dev)

    for arch, layers in REDUCED_DEPTH.items():
        full = get_arch(arch).make_config()
        cfg = dataclasses.replace(full, n_layers=layers)
        params = tr.init_params(cfg, seed=0, device=dev)
        prompts = torch.randint(0, cfg.vocab, (4, 2048), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
        run = serve.generate(params, prompts, cfg, 32, device=dev)
        n_k6 = run["launches"]["flash_attention"]
        require(n_k6 == layers, f"{arch} at {layers} layers: {n_k6} K6 launches in its prefill")
        logits = run["prefill_logits"]
        require(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (4, cfg.vocab)
                and run["tokens"].shape == (4, 32), f"{arch}: bad logits or tokens")
        prefill_ms = run["prefill_s"] * 1e3
        out[arch] = {"layers": f"{layers} of {full.n_layers}",
                     "why": f"{full.param_count() * 2 / 1e9:.0f} GB of bf16 weights whole; "
                            f"{layers} full-width layers and the embeddings are "
                            f"{cfg.param_count() * 2 / 1e9:.1f} GB of the card's 80",
                     "params": cfg.param_count(), "params_full": full.param_count(),
                     "prefill_ms": prefill_ms, "decode_ms": run["decode_s"] * 1e3,
                     "decode_tok_per_s": 4 * 31 / run["decode_s"], "launches": run["launches"],
                     "k6_ms_a_launch": k6[arch]["ms"],
                     "k6_share_by_kernel_check": n_k6 * k6[arch]["ms"] / prefill_ms}
        del params, run, logits
        torch.cuda.empty_cache()

    for dtype, (atol, rtol) in LOGIT_TOL.items():
        out[f"twin_{str(dtype).split('.')[-1]}"] = twin(granite, dtype, atol, rtol, dev)
        torch.cuda.empty_cache()
    out["moe_on_card"] = moe_on_card(granite, dev)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# phase: training the side models
# ----------------------------------------------------------------------

# the full qwen2.5-3b's training steps (batch 1 x 2,048 Markov tokens)
TRAIN_STEPS = 4
TRAIN_SEQ = 2048
# the two-layer float32 twin's step, K6 against the plain attention. Its
# forward differs from the plain one as K6's outputs do (ATTN_TOL: float32
# sums in another order, ~1e-6 relative); the backward is the same plain
# code on those inputs. loss: rtol 1e-6; grad_norm: rtol 1e-4; each gradient
# leaf: max |g_kernel - g_plain| <= 1e-4 x max |g_plain| of that leaf.
TWIN_LOSS_RTOL, TWIN_GNORM_RTOL, TWIN_GRAD_TOL = 1e-6, 1e-4, 1e-4
# the full xdeepfm's training steps at launch/train.py's batch
RECSYS_TRAIN_STEPS = 3
RECSYS_TRAIN_BATCH = 65536


def lm_grads(model, params, batch, use_kernel: bool):
    """(loss, gradient leaves) of ``tr.loss_fn`` by autograd, K6 or the plain
    attention in its forward."""
    from repro_torch.models import transformer as tr
    from repro_torch.tree import leaves

    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = tr.loss_fn(params, batch, model, device=batch["tokens"].device,
                      use_kernel=use_kernel)
    return loss.detach(), torch.autograd.grad(loss, flat)


def lm_train_steps(cfg, dev) -> tuple[dict, dict, dict]:
    """The full ``cfg`` takes TRAIN_STEPS ``make_lm_train`` steps at batch 1 x
    TRAIN_SEQ ``MarkovLMStream`` tokens (weights from seed 0, AdamW), K6
    counted from 0 around the steps: (its line, params, opt_state)."""
    from repro_torch.data.pipeline import MarkovLMStream
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    stream = MarkovLMStream(vocab=cfg.vocab, batch=1, seq=TRAIN_SEQ)
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=0, device=dev)
    opt_state = adamw.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = steps.make_lm_train(cfg, device=dev)
    batches = [{key: torch.from_numpy(val).to(dev) for key, val in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, gnorms = [], [], []
    ops.reset_launches()  # ---- K6 counted from here ----
    for batch in batches:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = ops.launches()  # ---- read right after the steps ----
    peak = torch.cuda.max_memory_allocated()
    require(launches["flash_attention"] == cfg.n_layers * TRAIN_STEPS,
            f"{cfg.name} training: {launches['flash_attention']} K6 launches in "
            f"{TRAIN_STEPS} steps, not {cfg.n_layers} a step")
    require(all(np.isfinite(losses + gnorms)) and int(opt_state["count"]) == TRAIN_STEPS,
            f"{cfg.name} training: loss {losses}, grad_norm {gnorms}")
    require(abs(losses[0] - np.log(cfg.vocab)) < 1.0,
            f"{cfg.name}'s first loss {losses[0]} is not near ln(vocab) {np.log(cfg.vocab)}")
    warm = statistics.median(step_s[1:])
    line = {
        "layers": cfg.n_layers, "dtype": str(cfg.param_dtype).split(".")[-1],
        "params": cfg.param_count(),
        "batch": [1, TRAIN_SEQ], "steps": TRAIN_STEPS, "init_s": init_s, "step_s": step_s,
        "step_ms_warm": warm * 1e3, "tokens_per_s": TRAIN_SEQ / warm, "losses": losses,
        "grad_norms": gnorms, "peak_gb": peak / 1e9, "launches": launches,
        "k6_launches_per_step": launches["flash_attention"] / TRAIN_STEPS}
    return line, params, opt_state


def train(dev, tmp: str) -> dict:
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import qwen2_5_3b, xdeepfm
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import MarkovLMStream, RecsysStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys as rc
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    out: dict = {"phase": "train"}
    t_phase = time.perf_counter()

    # -- the full qwen2.5-3b (36 layers, bf16), TRAIN_STEPS steps --
    cfg = qwen2_5_3b.make_config()
    out["qwen2.5-3b"], params, opt_state = lm_train_steps(cfg, dev)
    del params, opt_state
    torch.cuda.empty_cache()

    # -- the two-layer, full-width float32 twin: K6 against plain attention --
    model = dataclasses.replace(cfg, name="qwen2.5-3b-2l-float32", n_layers=2,
                                param_dtype=torch.float32)
    batch = {key: torch.from_numpy(val).to(dev) for key, val in
             MarkovLMStream(vocab=cfg.vocab, batch=1, seq=TRAIN_SEQ, seed=1).batch_at(0).items()}
    twin_out = {}
    grads = {}
    for use_kernel in (True, False):
        params = tr.init_params(model, seed=0, device=dev)
        paths = [path for path, _ in leaves_with_paths(params)]
        ops.reset_launches()
        loss, g = lm_grads(model, params, batch, use_kernel)
        torch.cuda.synchronize()
        n_k6 = ops.launches()["flash_attention"]
        it = iter(g)
        _, _, gn = adamw.update(tree_map(lambda _: next(it), params), adamw.init(params),
                                params, adamw.AdamWConfig())
        key = "kernel" if use_kernel else "plain"
        twin_out[key] = {"loss": float(loss), "grad_norm": float(gn), "k6_launches": n_k6}
        grads[key] = g
        del params
    require(twin_out["kernel"]["k6_launches"] == model.n_layers
            and twin_out["plain"]["k6_launches"] == 0, f"twin step launches: {twin_out}")
    lk, lp = twin_out["kernel"]["loss"], twin_out["plain"]["loss"]
    nk, np_ = twin_out["kernel"]["grad_norm"], twin_out["plain"]["grad_norm"]
    require(abs(lk - lp) <= TWIN_LOSS_RTOL * abs(lp), f"twin loss: {lk} against {lp}")
    require(abs(nk - np_) <= TWIN_GNORM_RTOL * abs(np_), f"twin grad_norm: {nk} against {np_}")
    worst = 0.0
    for path, a, b in zip(paths, grads["kernel"], grads["plain"]):
        scale = float(b.abs().max())
        ratio = float((a - b).abs().max()) / max(scale, 1e-30)
        worst = max(worst, ratio)
        require(ratio <= TWIN_GRAD_TOL, f"twin gradient {path}: max diff {ratio} of its max")
    twin_out.update(loss_rtol=TWIN_LOSS_RTOL, grad_norm_rtol=TWIN_GNORM_RTOL,
                    grad_tol=TWIN_GRAD_TOL, grad_leaves=len(paths),
                    worst_grad_diff_of_max=worst)
    out["twin_float32"] = twin_out
    del grads, batch
    torch.cuda.empty_cache()

    # -- the full granite-moe-1b-a400m (24 layers, bf16, MoE), TRAIN_STEPS
    # steps, then one checkpoint of (params, opt_state) by launch/train.py's own
    # save (layers stacked on the host) and restore (row by row) --
    t_granite = time.perf_counter()
    gcfg = get_arch("granite-moe-1b-a400m").make_config()
    out["granite-moe-1b-a400m"], params, opt_state = lm_train_steps(gcfg, dev)
    tree = (params, opt_state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves(tree))
    where = os.path.join(tmp, "granite_ckpt")
    t0 = time.perf_counter()
    ckpt.save(where, TRAIN_STEPS, train_cli._lm_to_ckpt(params, opt_state))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, step = ckpt.restore(where, tree, locate=train_cli._lm_locate)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(step == TRAIN_STEPS, f"restored step {step}")
    for (path, a), b in zip(leaves_with_paths(tree), leaves(restored)):
        require(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b),
                f"granite checkpoint leaf {path} restored differently")
    require(restored[0]["layers"][0]["router"]["w"].dtype == torch.float32
            and restored[0]["layers"][0]["w_gate"].ndim == 3, "granite checkpoint: MoE layout")
    out["granite-moe-1b-a400m"].update(checkpoint_bytes=nbytes, save_s=save_s,
                                        restore_s=restore_s, leaves=len(leaves(tree)),
                                        seconds=time.perf_counter() - t_granite)
    shutil.rmtree(where)
    del params, opt_state, tree, restored
    torch.cuda.empty_cache()

    # -- the full xdeepfm at launch/train.py's batch, then one checkpoint --
    rcfg = xdeepfm.make_config()
    rstream = RecsysStream(n_sparse=rcfg.n_sparse, bag=rcfg.bag_size, rows=rcfg.table_rows,
                           batch=RECSYS_TRAIN_BATCH)
    params = rc.init_params(rcfg, seed=0, device=dev)
    opt_state = adamw.init(params)
    rstep = steps.make_recsys_train(rcfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    r_s, r_losses = [], []
    for i in range(RECSYS_TRAIN_STEPS):
        batch = {key: torch.from_numpy(val).to(dev) for key, val in rstream.batch_at(i).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = rstep(params, opt_state, batch)
        torch.cuda.synchronize()
        r_s.append(time.perf_counter() - t0)
        r_losses.append(float(metrics["loss"]))
    require(all(np.isfinite(r_losses)) and abs(r_losses[0] - np.log(2)) < 0.1,
            f"xdeepfm training: losses {r_losses}")
    tree = (params, opt_state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves(tree))
    where = os.path.join(tmp, "xdeepfm_ckpt")
    t0 = time.perf_counter()
    ckpt.save(where, RECSYS_TRAIN_STEPS, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, step = ckpt.restore(where, tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(step == RECSYS_TRAIN_STEPS, f"restored step {step}")
    for (path, a), b in zip(leaves_with_paths(tree), leaves(restored)):
        require(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b),
                f"xdeepfm checkpoint leaf {path} restored differently")
    out["xdeepfm"] = {"batch": RECSYS_TRAIN_BATCH, "steps": RECSYS_TRAIN_STEPS, "step_s": r_s,
                      "step_ms_warm": statistics.median(r_s[1:]) * 1e3,
                      "rows_per_s": RECSYS_TRAIN_BATCH / statistics.median(r_s[1:]),
                      "losses": r_losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                      "leaves": len(leaves(tree))}
    shutil.rmtree(where)
    del params, opt_state, tree, restored, metrics
    torch.cuda.empty_cache()

    # -- in subprocesses: launch/train.py's resume (a dense and a MoE LM),
    # train_lm, the kNN example twins --
    for arch in ("qwen2.5-3b", "granite-moe-1b-a400m"):
        t_cli = time.perf_counter()
        ck_dir = os.path.join(tmp, "train_ckpt")
        args = ["--arch", arch, "--smoke", "--ckpt-dir", ck_dir, "--ckpt-every", "3",
                "--log-every", "2"]
        _, first = run_cli("repro_torch.launch.train", [*args, "--steps", "6"], 300, "train_cli",
                           json_out=False)
        _, resumed = run_cli("repro_torch.launch.train", [*args, "--steps", "8"], 300,
                             "train_cli", json_out=False)
        require(any(line.startswith("final loss") for line in first),
                f"launch.train --arch {arch}: {first[-1:]}")
        require("resumed from step 6" in resumed,
                f"launch.train --arch {arch} --steps 8 did not resume: {resumed}")
        shutil.rmtree(ck_dir)
        out[f"resume_{arch}_s"] = time.perf_counter() - t_cli
    lm15, _ = run_cli("repro_torch.examples.train_lm", [], 600, phase="train_lm")
    require(lm15["loss"] < lm15["first_loss"] - 0.5, f"train_lm: {lm15}")
    require(lm15["launches"]["flash_attention"] == 4 * lm15["steps"],
            f"train_lm: {lm15['launches']['flash_attention']} K6 launches")
    _, quick = run_cli("repro_torch.examples.quickstart", [], 600, "quickstart",
                       json_out=False)
    require("checks: 10 of 10 hold" in quick and "back to original: True" in quick,
            f"quickstart: {quick[-3:]}")
    _, service = run_cli("repro_torch.examples.knn_road_service", [], 600, "knn_road_service",
                         json_out=False)
    require(all(f"{name} tables equal a rebuild on its objects: True" in service
                for name in ("engine", "fleet")), f"knn_road_service: {service[-3:]}")
    out["train_lm"] = {key: lm15[key] for key in ("model", "steps", "first_loss", "loss",
                                                  "seconds", "launches")}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# phase: the GNN family (no kernel on its path)
# ----------------------------------------------------------------------

# Each architecture at its published width on the card against a float32 CPU
# run of the same port code on the same parameters and batch. index_add_ on
# the card sums a node's messages in no fixed order (atomics) and cuBLAS sums
# products in another order than the CPU's BLAS. On the CPU at full width (6
# molecules) float32 parted from float64 by 2.7e-6 in mace's loss and 5.2e-5
# in its worst gradient leaf, by ~1e-6 in egnn's and nequip's. So the loss is
# held within GNN_LOSS_RTOL of the CPU's, and each gradient leaf within
# GNN_GRAD_TOL x (scale + |cpu|), scale the larger of the leaf's largest |g|
# and GNN_GRAD_FLOOR of the tree's (mace's order-2 weights of antisymmetric
# CG paths multiply A x A, which is zero but for rounding, on both sides).
# Non-finite entries (egnn's zero-length edges) must sit at the same places.
GNN_LOSS_RTOL = 1e-4
GNN_GRAD_TOL = 1e-3
GNN_GRAD_FLOOR = 1e-6
# nequip's and mace's per-graph energies under a rotation and a shift:
# max |E(Rx + t) - E(x)| <= GNN_EQUIV_RTOL x max |E(x)| (on the CPU at full
# width, 6 molecules: 1.4e-9 and 2.2e-7)
GNN_EQUIV_RTOL = 1e-5
# gcn-cora at ogb_products: the card's float32 loss against the same forward
# in float64 on the card
OGB_LOSS_RTOL = 1e-4
# the train steps at ogb_products and of the sampled minibatch_lg pipeline
GNN_BIG_STEPS = 3
# minibatch_lg: 1,024 seeds, fanout (15, 10), on a 483 x 483 road network
# (233,289 vertices, standing in for the shape's 233k-node graph)
MB_SEEDS, MB_FANOUT, MB_GRID = 1024, (15, 10), 483


def gnn_grads(mod, params, batch, cfg):
    """(loss, gradient leaves) of ``mod.loss_fn`` by autograd; a leaf the
    loss does not reach gets zeros (JAX's value_and_grad)."""
    from repro_torch.tree import leaves

    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = mod.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), grads


def profiled_step(step_fn, params, opt_state, batch) -> tuple[dict, dict, dict]:
    """One more train step under ``torch.profiler`` (a measurement, not a
    path): its host time to the end of its work, the device time summed over
    its kernels (busy share = device / host), the kernels taking the most.
    Returns (that line, params, opt_state)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(row["device_us"] for row in kernels) / 1e3
    return ({"host_ms": host_ms, "device_ms": device_ms, "busy_share": device_ms / host_ms,
             "launches": sum(row["calls"] for row in kernels), "kernels": kernels[:6]},
            params, opt_state)


def gnn_home(name: str, shape: str, stream, dev) -> dict:
    """One architecture at its published width at its home shape: the card's
    loss and gradients against the CPU's, then TRAIN_STEPS AdamW steps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = get_arch(name).make_config(shape)
    mod = steps.GNN_MODULES[name]
    cpu_batch = {key: torch.from_numpy(val) for key, val in stream.batch_at(0).items()}
    batch = {key: val.to(dev) for key, val in cpu_batch.items()}
    n_nodes, n_edges = cpu_batch["pos"].shape[0], cpu_batch["edge_index"].shape[1]
    params_cpu = mod.init_params(cfg, seed=0, device="cpu")
    paths = [path for path, _ in leaves_with_paths(params_cpu)]
    t0 = time.perf_counter()
    loss_cpu, g_cpu = gnn_grads(mod, params_cpu, cpu_batch, cfg)
    cpu_s = time.perf_counter() - t0
    params = tree_map(lambda t: t.to(dev), params_cpu)
    loss, g = gnn_grads(mod, params, batch, cfg)
    loss2, g2 = gnn_grads(mod, params, batch, cfg)
    repeat_equal = bool(torch.equal(loss, loss2)) and all(same_nan(a, b) for a, b in zip(g, g2))
    del g2
    loss_err = abs(float(loss) - float(loss_cpu)) / max(abs(float(loss_cpu)), 1e-30)
    require(np.isfinite(float(loss)) and loss_err <= GNN_LOSS_RTOL,
            f"gnn {name}: loss {float(loss)} on the card, {float(loss_cpu)} on the CPU")
    finite = lambda t: torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    tree_max = max(float(finite(b).abs().max()) for b in g_cpu)
    worst, bad_card, bad_cpu = 0.0, 0, 0
    for path, a, b in zip(paths, g, g_cpu):
        a = a.cpu()
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        bad_card += int(not bool(fa.all()))
        bad_cpu += int(not bool(fb.all()))
        require(torch.equal(fa, fb), f"gnn {name}: gradient {path} non-finite elsewhere on the card")
        if not bool(fb.any()):
            continue
        scale = max(float(b[fb].abs().max()), GNN_GRAD_FLOOR * tree_max, 1e-30)
        worst = max(worst, float(((a[fb] - b[fb]).abs() / (scale + b[fb].abs())).max()))
    require(worst <= GNN_GRAD_TOL, f"gnn {name}: a gradient leaf {worst} off the CPU's")
    del g, g_cpu, params_cpu

    step_fn = steps.make_gnn_train(name, cfg, device=dev)
    opt_state = adamw.init(params)
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = {key: torch.from_numpy(val).to(dev) for key, val in stream.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    require(np.isfinite(losses[0]) and int(opt_state["count"]) == TRAIN_STEPS,
            f"gnn {name} training: losses {losses}")
    # egnn's gradients are NaN at the molecule stream's self loops (a
    # reference defect the port reproduces), so its parameters are NaN after
    # the first step; every other architecture trains finite
    require(name == "egnn" and bad_cpu > 0 or all(np.isfinite(losses)),
            f"gnn {name} training: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled, params, opt_state = profiled_step(step_fn, params, opt_state, batch)
    return {"shape": shape, "nodes": n_nodes, "edges": n_edges, "loss_card": float(loss),
            "loss_cpu": float(loss_cpu), "loss_rel_err": loss_err, "grad_leaves": len(paths),
            "grad_max_rel_err": worst, "nonfinite_leaves_card": bad_card,
            "nonfinite_leaves_cpu": bad_cpu, "repeat_bit_equal": repeat_equal, "cpu_s": cpu_s,
            "steps": TRAIN_STEPS, "step_s": step_s,
            "step_ms_warm": statistics.median(step_s[1:]) * 1e3, "losses": losses,
            "peak_gb": peak, "profiled_step": profiled}


def gnn_ogb(dev) -> dict:
    """gcn-cora at ogb_products (2,449,029 nodes, 61,859,140 edges, 100
    features): the float32 loss against the same forward in float64 on the
    card, then GNN_BIG_STEPS train steps."""
    from repro_torch.configs import gcn_cora
    from repro_torch.configs.common import gnn_shapes
    from repro_torch.data.pipeline import FullGraphStream
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import tree_map

    cell = gnn_shapes()["ogb_products"]
    stream = FullGraphStream(cell.n_true, cell.e_true, cell.d_feat, cell.n_classes)
    t0 = time.perf_counter()
    host = stream.batch_at(0)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = {key: torch.from_numpy(val).to(dev) for key, val in host.items()}
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    cfg = gcn_cora.make_config("ogb_products")
    params = gcn.init_params(cfg, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p64 = tree_map(lambda t: t.double(), params)
        logits = gcn.forward(p64, dict(batch, node_feat=batch["node_feat"].double()), cfg)
        lg = torch.log_softmax(logits, dim=-1)
        loss64 = float(-lg.gather(1, batch["labels"].long()[:, None]).mean())
        del p64, logits, lg
    peak64 = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    step_fn = steps.make_gnn_train("gcn-cora", cfg, device=dev)
    opt_state = adamw.init(params)
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for _ in range(GNN_BIG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled, params, opt_state = profiled_step(step_fn, params, opt_state, batch)
    err = abs(losses[0] - loss64) / abs(loss64)
    require(err <= OGB_LOSS_RTOL, f"gnn ogb_products: loss {losses[0]} against float64 {loss64}")
    require(all(np.isfinite(losses)) and abs(losses[0] - np.log(cfg.n_classes)) < 1.0,
            f"gnn ogb_products: losses {losses}")
    del batch, params, opt_state
    torch.cuda.empty_cache()
    return {"nodes": cell.n_true, "edges": cell.e_true, "d_feat": cell.d_feat,
            "classes": cell.n_classes, "batch_host_s": host_s, "upload_s": upload_s,
            "loss64": loss64, "loss_rel_err": err, "loss_rtol": OGB_LOSS_RTOL,
            "float64_peak_gb": peak64, "steps": GNN_BIG_STEPS, "step_s": step_s,
            "step_ms_warm": statistics.median(step_s[1:]) * 1e3, "losses": losses,
            "peak_gb": peak, "profiled_step": profiled}


def gnn_equivariance(batch: dict, dev) -> dict:
    """nequip's and mace's full-width per-graph energies on the molecule
    batch, rotated and shifted, against the unrotated ones."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn.common import scatter_sum
    from repro_torch.train import steps

    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.from_numpy(q.T.astype(np.float32)).to(dev)
    moved = dict(batch, pos=batch["pos"] @ rot + 7.5)
    n_graphs = batch["graph_targets"].shape[0]
    out = {"rtol": GNN_EQUIV_RTOL, "graphs": n_graphs}
    for name in ("nequip", "mace"):
        cfg = get_arch(name).make_config("molecule")
        mod = steps.GNN_MODULES[name]
        params = mod.init_params(cfg, seed=0, device=dev)
        with torch.no_grad():
            e1 = scatter_sum(mod.forward(params, batch, cfg)[:, 0], batch["graph_id"], n_graphs)
            e2 = scatter_sum(mod.forward(params, moved, cfg)[:, 0], batch["graph_id"], n_graphs)
        err = float((e2 - e1).abs().max() / e1.abs().max())
        require(bool(torch.isfinite(e1).all()) and err <= GNN_EQUIV_RTOL,
                f"gnn {name}: energies moved {err} of their largest under a rotation")
        out[name] = {"max_abs_energy": float(e1.abs().max()), "rel_err": err}
    return out


def gnn_minibatch(dev) -> dict:
    """The sampled pipeline at minibatch_lg: ``sample_khop`` (1,024 seeds,
    fanout 15-10) and ``pad_subgraph`` to the cell's 169,984 nodes and
    168,960 edges on a road network of 233,289 vertices, features and labels
    on the card, GNN_BIG_STEPS train steps of gcn-cora's minibatch_lg config."""
    from repro_torch.configs import gcn_cora
    from repro_torch.configs.common import gnn_shapes
    from repro_torch.graph.generators import road_network
    from repro_torch.graph.sampler import pad_subgraph, sample_khop
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    t0 = time.perf_counter()
    g = road_network(MB_GRID, MB_GRID, seed=0)
    graph_s = time.perf_counter() - t0
    cell = gnn_shapes()["minibatch_lg"]
    cfg = gcn_cora.make_config("minibatch_lg")
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((g.n, cfg.d_feat), generator=gen, device=dev)
    labels = torch.randint(0, cfg.n_classes, (g.n,), generator=gen, device=dev,
                           dtype=torch.int32)
    params = gcn.init_params(cfg, seed=0, device=dev)
    opt_state = adamw.init(params)
    step_fn = steps.make_gnn_train("gcn-cora", cfg, device=dev)
    rng = np.random.default_rng(0)
    sample_s, step_s, losses, real = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(GNN_BIG_STEPS):
        seeds = rng.choice(g.n, size=MB_SEEDS, replace=False)
        t0 = time.perf_counter()
        sub = sample_khop(g, seeds, MB_FANOUT, seed=step)
        real.append([len(sub.nodes), int(sub.edge_index.shape[1])])
        sub = pad_subgraph(sub, cell.n_nodes, cell.n_edges)
        sample_s.append(time.perf_counter() - t0)
        require(len(sub.seeds_local) == MB_SEEDS and sub.edge_index.shape == (2, cell.n_edges),
                f"gnn minibatch_lg: sampled {real[-1]}")
        nodes = torch.from_numpy(sub.nodes).to(dev)
        batch = {"node_feat": feats[nodes], "labels": labels[nodes],
                 "edge_index": torch.from_numpy(sub.edge_index).to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    require(all(np.isfinite(losses)), f"gnn minibatch_lg: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled, params, opt_state = profiled_step(step_fn, params, opt_state, batch)
    pad_share = 1 - statistics.mean(e for _, e in real) / cell.n_edges
    return {"graph": f"road_network({MB_GRID}, {MB_GRID})", "vertices": g.n,
            "max_degree": int(g.degrees().max()), "graph_s": graph_s, "seeds": MB_SEEDS,
            "fanout": list(MB_FANOUT), "pad": [cell.n_nodes, cell.n_edges],
            "sampled_nodes_edges": real, "edge_pad_share": pad_share,
            "note": "a road network's degree of at most ~4 (a few diagonals more) leaves "
                    "most of the pad, sized for fanout 15-10, as padding",
            "sample_host_s": sample_s, "steps": GNN_BIG_STEPS, "step_s": step_s,
            "step_ms_warm": statistics.median(step_s[1:]) * 1e3, "losses": losses,
            "peak_gb": peak, "profiled_step": profiled}


def run_clis(jobs: dict[str, list[str]], timeout: float) -> dict[str, list[str]]:
    """``python -m repro_torch.launch.train <args>`` for every job at once,
    from the checkout: each job's stdout lines. A non-zero exit or the
    timeout fails the phase; no process outlives the call."""
    procs = {}
    try:
        for name, args in jobs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=SRC))
        deadline = time.perf_counter() + timeout
        out = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=max(deadline - time.perf_counter(), 1))
            require(proc.returncode == 0, f"launch.train {' '.join(jobs[name])} exited "
                    f"{proc.returncode}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
            out[name] = stdout.strip().splitlines()
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def gnn_cli(tmp: str) -> dict:
    """``launch.train`` in subprocesses: each GNN with --smoke, nequip on the
    JAX driver's full molecule stream, mace resumed from its step 6."""
    from repro_torch.train.steps import GNN_MODULES

    t0 = time.perf_counter()
    ck_dir = os.path.join(tmp, "gnn_ckpt")
    resume = ["--arch", "mace", "--smoke", "--ckpt-dir", ck_dir, "--ckpt-every", "3"]
    jobs = {f"{arch} --smoke": ["--arch", arch, "--smoke", "--steps", "4"] for arch in GNN_MODULES}
    jobs["nequip molecule"] = ["--arch", "nequip", "--steps", "3", "--log-every", "1"]
    jobs["mace --smoke 6"] = [*resume, "--steps", "6"]
    first = run_clis(jobs, 300)
    resumed = run_clis({"mace --smoke 8": [*resume, "--steps", "8"]}, 300)
    printed = {**first, **resumed}
    for name, lines in printed.items():
        require(any(line.startswith("final loss") for line in lines), f"launch.train {name}: "
                f"{lines[-3:]}")
    require("resumed from step 6" in printed["mace --smoke 8"],
            f"launch.train mace --steps 8 did not resume: {printed['mace --smoke 8']}")
    shutil.rmtree(ck_dir)
    return {"runs": {name: lines[-3:] for name, lines in printed.items()},
            "seconds": time.perf_counter() - t0}


def gnn(dev, tmp: str) -> dict:
    from repro_torch.configs.common import gnn_shapes
    from repro_torch.data.pipeline import FullGraphStream, GraphStream
    from repro_torch.kernels import ops

    out: dict = {"phase": "gnn", "tolerances": {
        "loss_rtol": GNN_LOSS_RTOL, "grad_tol": GNN_GRAD_TOL, "grad_floor": GNN_GRAD_FLOOR,
        "equivariance_rtol": GNN_EQUIV_RTOL, "ogb_loss_rtol": OGB_LOSS_RTOL}}
    t_phase = time.perf_counter()
    ops.reset_launches()  # ---- no kernel lies on the GNN path ----
    cells = gnn_shapes()
    cora, mol = cells["full_graph_sm"], cells["molecule"]
    molecule = GraphStream(n_nodes=mol.n_true // mol.graphs, n_edges=mol.e_true // mol.graphs,
                           batch=mol.graphs)
    homes = {"gcn-cora": ("full_graph_sm", FullGraphStream(cora.n_true, cora.e_true,
                                                           cora.d_feat, cora.n_classes))}
    homes.update({name: ("molecule", molecule) for name in ("egnn", "nequip", "mace")})
    for name, (shape, stream) in homes.items():
        out[name] = gnn_home(name, shape, stream, dev)
        torch.cuda.empty_cache()
    batch = {key: torch.from_numpy(val).to(dev) for key, val in molecule.batch_at(0).items()}
    out["equivariance"] = gnn_equivariance(batch, dev)
    del batch
    out["ogb_products"] = gnn_ogb(dev)
    out["minibatch_lg"] = gnn_minibatch(dev)
    torch.cuda.empty_cache()
    out["kernel_launches"] = ops.launches()
    require(not any(out["kernel_launches"].values()),
            f"gnn: a kernel launched on the GNN path: {out['kernel_launches']}")
    out["cli"] = gnn_cli(tmp)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the cell catalogue: the dry run, and the serving cells on the card
# ---------------------------------------------------------------------------

# qwen2.5-3b's published serving batches do not fit one 80 GB card: at 32 x
# 32,768 the bf16 KV cache alone is 36 x 2 x 32 x 32,768 x 2 x 128 x 2 B =
# 38.7 GB, beside ~1.4 GB a sequence a layer of FFN activations and 6.2 GB
# of parameters, and decode's 128 x 32,768 cache is 155 GB. So prefill runs
# at batch 8 and decode at cache batch 32, at full width and depth.
CELL_CUTS = {"prefill_32k": 8, "decode_32k": 32}
DRYRUN_CELLS = 37
DRYRUN_TIMEOUT = 600


def dryrun_proc(out_dir: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                             "--out", out_dir], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def dryrun_records(proc: subprocess.Popen, out_dir: str, t0: float) -> dict:
    """The dry run's 37 records, checked: flops, bytes, terms, bottleneck."""
    stdout, stderr = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    lines = stdout.splitlines()
    require(proc.returncode == 0, f"dryrun --all exited {proc.returncode}:\n{stdout[-3000:]}\n"
            f"{stderr[-3000:]}")
    require(sum(line.startswith("OK    ") for line in lines) == DRYRUN_CELLS
            and not any(line.startswith(("SKIP", "FAIL")) for line in lines),
            f"dryrun --all printed {len(lines)} lines, not {DRYRUN_CELLS} OK lines")
    names = sorted(os.listdir(out_dir))
    require(len(names) == DRYRUN_CELLS, f"dryrun --all wrote {len(names)} records")
    table = {}
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        flops = r["per_device"]["flops"]
        require((flops == 0) == (r["arch"] == "knn-index"),
                f"{r['arch']}/{r['shape']}: {flops} flops counted")
        require(r["mesh"] == "1xH100" and r["n_chips"] == 1, f"{name}: mesh {r['mesh']}")
        table[f"{r['arch']}/{r['shape']}"] = {
            "flops": flops, "bytes": r["per_device"]["hbm_bytes"],
            "terms_s": r["roofline_terms_s"], "bottleneck": r["bottleneck"],
            "kernels": {k: v["calls"] for k, v in r["kernels"].items()}}
    return {"seconds": time.perf_counter() - t0, "records": table}


def cut_batch(cell, batch: int):
    """An LM serving cell with its batch cut to ``batch``, the rest as
    published: (the cut cell, the published batch)."""
    from repro_torch.configs.common import ShapeCell

    def specs(cfg):
        s = dict(cell.specs(cfg))
        shape, dtype = s["tokens"]
        s["tokens"] = ((batch, *shape[1:]), dtype)
        if "cache_batch" in s:
            s["cache_batch"] = batch
        return s

    return ShapeCell(cell.kind, specs), cell.specs(None)["tokens"][0][0]


def cell_events_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def cell_on_card(arch_id: str, shape: str, cell, dev, *, variant=None, use_kernel=True):
    """Build the cell's step on the card, run it once warm under the count
    (launches counted from 0 around it) and once timed: (the step, its
    arguments, the warm call's output, a report)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    arch = get_arch(arch_id)
    meta = dryrun.count_step(*dryrun.build_cell(arch, shape, cell, variant)[:2])[0]
    fn, args, _ = dryrun.build_cell(arch, shape, cell, variant, device=dev,
                                    use_kernel=use_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # ---- this cell's launches are counted from here ----
    with torch.no_grad():
        card, out = dryrun.count_step(fn, args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if v}  # ---- read right after ----
        ms = cell_events_ms(lambda: fn(*args))
    require((card.flops, card.bytes) == (meta.flops, meta.bytes),
            f"{arch_id}/{shape}: counted {card.flops} flops, {card.bytes} bytes on the card, "
            f"{meta.flops}, {meta.bytes} on meta")
    terms = meta.roofline_terms_s()
    report = {"ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches, "flops": meta.flops, "bytes": meta.bytes,
              "card_count": [card.flops, card.bytes], "meta_count": [meta.flops, meta.bytes],
              "roofline_terms_s": terms, "bottleneck": max(terms, key=terms.get),
              "share": max(terms.values()) / (ms / 1e3)}
    return fn, args, out, report


def cells(dev, tmp: str) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    out: dict = {"phase": "cells", "reduced": {}}
    dry_dir = os.path.join(tmp, "dryrun")
    proc = dryrun_proc(dry_dir)
    try:
        # knn-index build_sweep: K1, then the plain step on the same tables
        knn = get_arch("knn-index")
        build = knn.shapes["build_sweep"]
        _, args, got, rep = cell_on_card("knn-index", "build_sweep", build, dev)
        require(rep["launches"] == {"topk_merge": 1},
                f"build_sweep launched {rep['launches']}, not one topk_merge")
        # the step writes its tables in place, and the card's ran twice (warm,
        # timed): so does the plain step, on tables drawn from the same seed
        fn_p, args_p, _ = dryrun.build_cell(knn, "build_sweep", build, device=dev,
                                            use_kernel=False)
        with torch.no_grad():
            fn_p(*args_p)
            want = fn_p(*args_p)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                "build_sweep: K1's tables differ from the plain step's")
        verts = args[0]
        require(bool((want[0][verts.long()] != -1).any()), "build_sweep: no row merged")
        del args, got, fn_p, args_p, want
        torch.cuda.empty_cache()
        # the contiguous form on rows 0..S-1 against the scatter form there
        _, args_c, got_c, rep_c = cell_on_card("knn-index", "build_sweep", build, dev,
                                               variant={"knn_contig": "1"})
        fn_s, args_s, _ = dryrun.build_cell(knn, "build_sweep", build, device=dev)
        s = args_s[1].shape[0]
        rows = torch.arange(s, dtype=torch.int32, device=dev)
        with torch.no_grad():
            fn_s(rows, *args_s[1:])
            want_s = fn_s(rows, *args_s[1:])
        require(torch.equal(got_c[0], want_s[0]) and torch.equal(got_c[1], want_s[1]),
                "build_sweep knn_contig: tables differ from the scatter form's")
        out["build_sweep"] = {**rep, "rows": int(args_s[5].shape[0]), "level_batch": s,
                              "knn_contig": rep_c}
        del args_c, got_c, fn_s, args_s, want_s
        torch.cuda.empty_cache()
        # serve_batch: 2^20 queries
        _, args, got, rep = cell_on_card("knn-index", "serve_batch", knn.shapes["serve_batch"],
                                         dev)
        q = args[2].long()
        require(torch.equal(got[0], torch.index_select(args[0], 0, q))
                and torch.equal(got[1], torch.index_select(args[1], 0, q)),
                "serve_batch differs from a direct row read")
        out["serve_batch"] = {**rep, "queries": int(q.numel())}
        del args, got, q
        torch.cuda.empty_cache()
        # xdeepfm's three serving cells
        rec = get_arch("xdeepfm")
        for shape in ("serve_p99", "serve_bulk"):
            _, args, logits, rep = cell_on_card("xdeepfm", shape, rec.shapes[shape], dev)
            b = args[1]["sparse_ids"].shape[0]
            require(tuple(logits.shape) == (b,) and bool(torch.isfinite(logits).all()),
                    f"xdeepfm {shape}: bad logits")
            out[shape] = {**rep, "batch": b}
            del args, logits
        cand = rec.shapes["retrieval_cand"]
        _, args, got, rep = cell_on_card("xdeepfm", "retrieval_cand", cand, dev)
        require(rep["launches"] == {"retrieval_topk": 1},
                f"retrieval_cand launched {rep['launches']}, not one retrieval_topk")
        fn_p, args_p, _ = dryrun.build_cell(rec, "retrieval_cand", cand, device=dev,
                                            use_kernel=False)
        with torch.no_grad():
            want = fn_p(*args_p)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                "retrieval_cand: K5's ids and scores differ from the plain step's")
        out["retrieval_cand"] = {**rep, "k": int(got[0].shape[1])}
        del args, got, fn_p, args_p, want
        torch.cuda.empty_cache()
        # qwen2.5-3b at full width and depth, batches cut (CELL_CUTS)
        lm = get_arch("qwen2.5-3b")
        cfg = lm.make_config()
        prefill, published = cut_batch(lm.shapes["prefill_32k"], CELL_CUTS["prefill_32k"])
        out["reduced"]["prefill_32k"] = {"batch": {"published": published,
                                                   "run": CELL_CUTS["prefill_32k"]}}
        _, args, (logits, cache), rep = cell_on_card("qwen2.5-3b", "prefill_32k", prefill, dev)
        require(rep["launches"] == {"flash_attention": cfg.n_layers},
                f"prefill_32k launched {rep['launches']}, not {cfg.n_layers} flash_attention")
        require(tuple(logits.shape) == (CELL_CUTS["prefill_32k"], cfg.vocab)
                and bool(torch.isfinite(logits).all()), "prefill_32k: logits not finite")
        out["prefill_32k"] = {**rep, "batch": CELL_CUTS["prefill_32k"]}
        del args, logits, cache
        torch.cuda.empty_cache()
        decode, published = cut_batch(lm.shapes["decode_32k"], CELL_CUTS["decode_32k"])
        out["reduced"]["decode_32k"] = {"cache_batch": {"published": published,
                                                        "run": CELL_CUTS["decode_32k"]}}
        fn, args, (logits, cache), rep = cell_on_card("qwen2.5-3b", "decode_32k", decode, dev)
        step_ms = []
        with torch.no_grad():
            for _ in range(TRAIN_STEPS):
                tok, res = logits.argmax(-1).to(torch.int32), []
                step_ms.append(cell_events_ms(lambda: res.append(fn(args[0], cache, tok))))
                logits, cache = res[0]
        require(bool(torch.isfinite(logits).all()) and cache["len"] == 2 + TRAIN_STEPS,
                f"decode_32k: logits not finite or cache at {cache['len']}")
        out["decode_32k"] = {**rep, "cache_batch": CELL_CUTS["decode_32k"], "step_ms": step_ms}
        del fn, args, logits, cache
        torch.cuda.empty_cache()
        out["card_s"] = time.perf_counter() - t_phase
        out["dryrun"] = dryrun_records(proc, dry_dir, t_phase)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=MAIN_GRID, help="road-network side of the main path")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print each kernel's registers and shared memory while building")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path", file=sys.stderr)
        return 1
    from repro_torch.analysis import sanitize
    from repro_torch.configs.knn_index import make_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    print(smi, flush=True)

    with sanitize.count_builds() as built:
        build_s = _build.build_all(verbose=args.verbose_build)
    say({"phase": "build", "seconds": build_s, "built": built.libraries,
         "sources": [f"src/repro_torch/kernels/csrc/{name}.cu" for name in _build.KERNELS]})

    cfg = make_config()
    results: dict = {}
    for check in (check_topk_merge, check_sweep_merge, check_frontier_relax, check_minplus):
        check(cfg, dev, results)
        torch.cuda.empty_cache()
        name = check.__name__[len("check_"):]
        for entry in (name, "sweep_merge_levels") if name == "sweep_merge" else (name,):
            say({"phase": "kernel_check", "kernel": entry, "config": cfg.name, **results[entry]})
    check_retrieval_topk(dev, results)
    torch.cuda.empty_cache()
    say({"phase": "kernel_check", "kernel": "retrieval_topk", "config": "xdeepfm",
         **results["retrieval_topk"]})
    check_flash_attention(dev, results)
    torch.cuda.empty_cache()
    say({"phase": "kernel_check", "kernel": "flash_attention", "config": "qwen2.5-3b",
         **results["flash_attention"]})

    tmp = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    cert = certify(CERT_GRID, dev, results)
    say(cert)
    cli(CERT_GRID, tmp)
    out, state = main_path(args.grid, cfg.k, dev)
    say(out)
    say(durability(state, tmp))
    shard = sharded(state, tmp)
    say(shard)
    say(sanitize_phase(state, built.libraries))
    del state
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    rec = recsys(dev)
    say(rec)
    torch.cuda.empty_cache()
    lm_out = lm(dev)
    say(lm_out)
    torch.cuda.empty_cache()
    archs_out = lm_archs(dev, results)
    say(archs_out)
    torch.cuda.empty_cache()
    os.makedirs(tmp)
    train_out = train(dev, tmp)
    say(train_out)
    torch.cuda.empty_cache()
    say(gnn(dev, tmp))
    torch.cuda.empty_cache()
    cells_out = cells(dev, tmp)
    say(cells_out)
    shutil.rmtree(tmp)
    # the MoE and newer-LM work: K6 at their head layouts, the lm_archs phase,
    # granite's training, checkpoint and launch.train resume
    say({"phase": "lm_archs_work_seconds",
         "seconds": results["flash_attention"]["head_layouts_s"] + archs_out["seconds"]
         + train_out["granite-moe-1b-a400m"]["seconds"]
         + train_out["resume_granite-moe-1b-a400m_s"]})
    say({"phase": "total", "seconds": time.perf_counter() - t_start})

    # which run each kernel's launch count covers: the main path runs K1-K3
    # (K2 as sweep_merge_levels in the build, one launch a sweep, and as
    # sweep_merge in the flushes' repair rounds),
    # the certificate minplus, the recsys retrieval retrieval_topk, the full
    # qwen2.5-3b's training steps flash_attention (counted from 0 just before
    # them; launches_lm: serve.py's prefill; launches_lm_archs: the granite-moe
    # and internlm2 prefills of serve.py). The numbers beside each count are its
    # kernel check's (minplus at 4096^3, its time at the certificate's own
    # shape is on the certify line; retrieval_topk at the retrieval cell's
    # (1, 10^6); flash_attention at the prefill's (4, 2048, 16/2, 128))
    replaces = {
        "topk_merge": "src/repro/kernels/topk_merge.py:59",
        "sweep_merge": "src/repro/kernels/sweep_merge.py:112",
        "sweep_merge_levels": "src/repro/kernels/sweep_merge.py:112",
        "frontier_relax": "src/repro/kernels/frontier_relax.py:70",
        "minplus": "src/repro/kernels/minplus.py:39",
        "retrieval_topk": "src/repro/kernels/retrieval_topk.py:58",
        "flash_attention": "src/repro/kernels/flash_attention.py:64",
    }
    counted = {name: ("main_path", out["launches"][name], results[name])
               for name in ("topk_merge", "sweep_merge", "sweep_merge_levels", "frontier_relax")}
    # the phases that run each kernel (the sharded engines' own launches in
    # their phase, under launches_sharded)
    phases = {name: ["main_path", "sharded"]
              for name in ("topk_merge", "sweep_merge", "sweep_merge_levels", "frontier_relax")}
    phases.update(minplus=["certify", "cli"], retrieval_topk=["recsys", "cells"],
                  flash_attention=["lm", "lm_archs", "train", "cells"])
    phases["topk_merge"].append("cells")
    counted["minplus"] = ("certify", cert["launches"]["minplus"], results["minplus"])
    counted["retrieval_topk"] = ("recsys", rec["launches"]["retrieval_topk"],
                                 results["retrieval_topk"])
    counted["flash_attention"] = (
        "train", train_out["qwen2.5-3b"]["launches"]["flash_attention"],
        {**results["flash_attention"],
         "launches_lm": lm_out["serve"]["launches"]["flash_attention"],
         "launches_lm_archs": {arch: archs_out[arch]["launches"]["flash_attention"]
                               for arch in ("granite-moe-1b-a400m", "internlm2-20b")}})
    # the cells phase's launches of K1 (build_sweep, scatter and contiguous
    # forms), K5 (retrieval_cand) and K6 (prefill_32k)
    cells_launches = {
        "topk_merge": {"build_sweep": cells_out["build_sweep"]["launches"]["topk_merge"],
                       "build_sweep_knn_contig":
                       cells_out["build_sweep"]["knn_contig"]["launches"]["topk_merge"]},
        "retrieval_topk": {"retrieval_cand":
                           cells_out["retrieval_cand"]["launches"]["retrieval_topk"]},
        "flash_attention": {"prefill_32k":
                            cells_out["prefill_32k"]["launches"]["flash_attention"]},
    }
    say({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name.removesuffix('_levels')}.cu",
         "replaces": replaces[name], "launches": counted[name][1],
         "launches_phase": counted[name][0], "phases": phases[name],
         **({"launches_sharded": shard["launches"][name]} if "sharded" in phases[name] else {}),
         **({"launches_cells": cells_launches[name]} if name in cells_launches else {}),
         **{key: counted[name][2][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            + tuple(key for key in ("dtype_routes", "launches_per_call", "launches_lm",
                                    "launches_lm_archs")
                    if key in counted[name][2])}}
        for name in replaces
    ]})
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
