"""Times K6 in bf16 at D = 64 in each design: the CUDA-core FMA route it
left, and the wgmma kernel at each ring depth and blocks an SM.

    python3 tools/k6_variants.py

For each wgmma variant it copies ``csrc/flash_attention.cu`` into a
temporary directory (the checkout's own source is never touched), edits the
copy's D = 64 ring depth (``Cfg<64>::STAGES``) and the blocks an SM it is
built for (``__launch_bounds__``' second argument at D = 64, so ptxas caps
the registers a thread at what that many blocks of nine warps leave on the
busiest of the SM's four schedulers, 16,384 registers each: 96 at two
blocks), appends an occupancy query, and builds it (``-Xptxas -v``), all
variants at once. It prints what ptxas says of the D = 64 kernel (registers,
spill stores and loads), the blocks an SM holds by the occupancy calculator,
and, at each shape, its answer against the plain version at the route's kv
tile (``chip_smoke.attn_held``) and its time (CUDA events, the median of
``REPS`` launches through the C entry), with
``scaled_dot_product_attention`` timed in the same loop. The variant the
checkout builds is marked ``"default"``. The ``"fma"`` design is the
checkout's own kernel called with the FMA route's code (2), which the C
entry still takes at D = 64 (``ops`` no longer sends bf16 D = 64 there).

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per design. Exits 1 if a variant fails to build or to hold its
bounds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
KERNEL = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
# (stages, blocks an SM) of the wgmma kernel at D = 64; the first is the
# checkout's own
VARIANTS = ((3, 1), (2, 1), (4, 1), (2, 2), (1, 2))
STAGES_TEXT = "struct Cfg<64> {\n  static constexpr int STAGES = 3;\n};"
BOUNDS_TEXT = "__launch_bounds__(THREADS, 1)"
OCCUPANCY = """
extern "C" int k6_blocks_per_sm() {
  int n = 0;
  return hopper::allow_smem<64>() == cudaSuccess &&
                 cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, hopper::attention_wgmma<64>, hopper::THREADS,
                     hopper::smem_bytes<64>()) == cudaSuccess
             ? n
             : -1;
}
"""
# (batch, length, heads, kv heads, causal) at D = 64, bf16: granite-moe's
# prefill layout, the same at GQA groups of 8, granite non-causal, and
# granite's train step (batch 1)
SHAPES = ((4, 2048, 16, 8, True), (4, 2048, 16, 2, True), (4, 2048, 16, 8, False),
          (1, 2048, 16, 8, True))


def variant_source(stages: int, blocks: int) -> str:
    """The kernel's source with the D = 64 ring at ``stages`` and built for
    ``blocks`` blocks an SM, plus the occupancy query."""
    with open(KERNEL) as f:
        text = f.read()
    for old in (STAGES_TEXT, BOUNDS_TEXT):
        if text.count(old) != 1:
            raise SystemExit(f"k6_variants: {old!r} occurs {text.count(old)} times in "
                             f"{KERNEL}, not once")
    text = text.replace(STAGES_TEXT, STAGES_TEXT.replace("= 3", f"= {stages}"))
    text = text.replace(BOUNDS_TEXT, f"__launch_bounds__(THREADS, D == 64 ? {blocks} : 1)")
    return text + OCCUPANCY


def ptxas_info(text: str, function: str) -> dict:
    """Registers and spill bytes of the entry whose mangled name holds
    ``function``, from ``-Xptxas -v`` output."""
    for part in text.split("Compiling entry function")[1:]:
        if function not in part.split("\n")[0]:
            continue
        out = {}
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if regs:
            out["registers"] = int(regs.group(1))
        if spill:
            out["spill_stores"], out["spill_loads"] = map(int, spill.groups())
        return out
    return {}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    cases = []
    for b, s, h, hkv, causal in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                   for shape in ((b, s, h, 64), (b, s, hkv, 64), (b, s, hkv, 64)))
        want = {route: ref.flash_attention_ref(q, k, v, causal=causal, kv_block=tile)
                for route, tile in cs.ATTN_KV_TILE.items()}
        cases.append(((b, s, h, hkv, causal), (q, k, v), want))

    tmp = tempfile.mkdtemp(prefix="k6_variants_")
    procs = []
    for stages, blocks in VARIANTS:  # every build at once
        src = os.path.join(tmp, f"k6_{stages}_{blocks}.cu")
        with open(src, "w") as f:
            f.write(variant_source(stages, blocks))
        lib = os.path.join(tmp, f"libk6_{stages}_{blocks}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src]
        procs.append((stages, blocks, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # the FMA design first (the default variant's library, route code 2), then
    # each wgmma variant (code 1)
    designs = [("fma", *procs[0])] + [("wgmma", *p) for p in procs]
    built: dict = {}
    bad = False
    for route, stages, blocks, lib, proc in designs:
        if lib not in built:
            _, err = proc.communicate()
            built[lib] = (proc.returncode, err)
        returncode, err = built[lib]
        line = ({"design": "fma"} if route == "fma" else
                {"design": "wgmma", "stages": stages, "blocks": blocks,
                 "default": (stages, blocks) == VARIANTS[0]})
        if returncode != 0:
            print(err[-3000:], file=sys.stderr)
            print(json.dumps({**line, "built": False}), flush=True)
            bad = True
            continue
        so = ctypes.CDLL(lib)
        if route == "wgmma":
            line.update(ptxas_info(err, "attention_wgmmaILi64E"))
            line["d128"] = ptxas_info(err, "attention_wgmmaILi128E")
            line["blocks_per_sm"] = so.k6_blocks_per_sm()
        fn = so.knn_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = 1 if route == "wgmma" else 2
        line["shapes"] = []
        for (b, s, h, hkv, causal), (q, k, v), want in cases:
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, b, s, s,
                        h, hkv, 64, int(causal), 64**-0.5, stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")

            def sdpa():
                F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), is_causal=causal,
                                               enable_gqa=True)

            launch()
            torch.cuda.synchronize()
            held = cs.attn_held(out, want[route], route)
            ok = all(x["ok"] for x in held.values())
            bad |= not ok
            ms, lib_ms = [], []
            for _ in range(REPS):  # in turns, so both see the same clocks
                ms.append(cs.cuda_ms(launch, reps=1, warm=0))
                lib_ms.append(cs.cuda_ms(sdpa, reps=1, warm=0))
            line["shapes"].append({
                "shape": f"({b}, {s}, {h}/{hkv}, 64) {'causal' if causal else 'non-causal'}",
                "ok": ok, "ratio_ulps": held["ulps"]["ratio"], "ms": statistics.median(ms),
                "library_ms": statistics.median(lib_ms)})
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
