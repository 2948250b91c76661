"""Shows that chip_smoke.py's checks of K6's bf16 routes catch a broken kernel.

For the kernel as it is and for each planted fault, copies ``src/`` and
``chip_smoke.py`` into a work directory, edits the copy's
``csrc/flash_attention.cu`` there (the checkout's own sources are never
touched), and runs in a process of its own, which builds the copy's kernels
and measures, on the faulted route (both routes for the intact kernel):

- wgmma (bf16 at D = 64 and 128, one template, so a fault planted there is
  in both): K6 at (4, 2048, 16/2, 128), (1, 32768, 16/2, 128), (4, 2048,
  16/2, 64) and granite-moe's (4, 2048, 16/8, 64), causal, and the two-layer
  bf16 twin's prefill logits with K6 against those with the plain attention,
  beside chip_smoke's LOGIT_TOL;
- fma (bf16 at D in {8, 16, 32}): K6 at (4, 2048, 16/2, D) for D = 8, 16,
  32 and at (2, 300, 8/2, 8), causal;

each against its plain version at the route's kv tile (chip_smoke's
``attn_plain``) under chip_smoke's bounds (``attn_held``: ATTN_TOL, and the
route's ATTN_ULPS_BF16); a ratio over 1 fails a bound.

Each fault touches only the heaviest query tile of each (b, h) (the last 128
rows on the wgmma route, 64 on the fma route), at the middle one of its kv
tiles, so that a tile of those rows' ~2,000 keys is wrong at 2,048 and one
of ~32,700 at 32,768:

- ``drop_tile`` / ``drop_tile_fma``: the tile's scores are set to -inf, as
  if it were skipped;
- ``stale_stage``: its K and V are read from the wgmma ring's previous stage
  (the tile before it, or the one the loader is bringing in its place);
- ``stale_stage_fma``: its K is not staged, so its scores are taken against
  what the stage still holds, the previous tile's V.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit, then
one JSON line per variant. Exits 1 if the kernel as it is fails a bound, or if
a fault passes every bound at any of its route's shapes.

    python3 tools/k6_planted_faults.py [--workdir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join("src", "repro_torch", "kernels", "csrc", "flash_attention.cu")
# the heaviest query tile's middle kv tile, on each route
FAULT = "blockIdx.y == 0 && it == n_kv / 2"
FAULT_FMA = "blockIdx.x == gridDim.x - 1 && k0 == (kv_end + BK - 1) / BK / 2 * BK"

# variant: (the route it breaks, [(text in the kernel, its replacement)]);
# each text must occur exactly once
FAULTS = {
    "intact": (None, []),
    "drop_tile": ("wgmma", [(
        "    // a mask only where the tile holds T",
        f"    if ({FAULT})  // planted fault\n"
        "      for (int x = 0; x < 64; ++x) s[x] = __int_as_float(0xff800000);\n"
        "    // a mask only where the tile holds T",
    )]),
    "stale_stage": ("wgmma", [
        ("    const int k0 = it * BK;\n",
         "    const int k0 = it * BK;\n"
         f"    const int fst = {FAULT} ? (st + STAGES - 1) % STAGES : st;  // planted fault\n"),
        ("sw128(sm.k(st) + off, 16, 1024)", "sw128(sm.k(fst) + off, 16, 1024)"),
        ("sw128(sm.v(st) + kk * 2048, BOX_BYTES, 1024)",
         "sw128(sm.v(fst) + kk * 2048, BOX_BYTES, 1024)"),
    ]),
    "drop_tile_fma": ("fma", [(
        "        sc[i][j] = keep ? sc[i][j] * scale : neg_inf;\n",
        f"        sc[i][j] = keep && !({FAULT_FMA}) ? sc[i][j] * scale : neg_inf;"
        "  // planted fault\n",
    )]),
    "stale_stage_fma": ("fma", [(
        "    stage<T, D>(kv, LD, kh, kv_stride, k0, BK, t_len);\n",
        f"    if (!({FAULT_FMA}))  // planted fault: the stage keeps the last tile's V\n"
        "      stage<T, D>(kv, LD, kh, kv_stride, k0, BK, t_len);\n",
    )]),
}
# (batch, length, heads, kv heads, head dim) of each route, causal, bf16
SHAPES = {
    "wgmma": ((4, 2048, 16, 2, 128), (1, 32768, 16, 2, 128), (4, 2048, 16, 2, 64),
              (4, 2048, 16, 8, 64)),
    "fma": (*((4, 2048, 16, 2, d) for d in (8, 16, 32)), (2, 300, 8, 2, 8)),
}


def plant(copy: str, edits: list[tuple[str, str]]) -> None:
    path = os.path.join(copy, KERNEL)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"k6_planted_faults: {old!r} occurs {text.count(old)} times "
                             f"in {KERNEL}, not once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def measure(routes: list[str]) -> dict:
    """In a copy: K6 at the routes' SHAPES, and the bf16 twin's prefill logits
    where the wgmma route is measured."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import qwen2_5_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    attention = []
    for route in routes:
        for b, s, h, hkv, d in SHAPES[route]:
            assert ops.flash_attention_route(bf16, d)[0] == route
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                       for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
            got = ops.flash_attention(q, k, v, causal=True)
            want = cs.attn_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            rows = 128 if route == "wgmma" else 64
            attention.append({"route": route, "B": b, "S": s, "H": h, "Hkv": hkv, "D": d,
                              "max_abs_err": cs.max_abs_err(got, want),
                              "max_abs_err_last_tile": cs.max_abs_err(got[:, -rows:],
                                                                      want[:, -rows:]),
                              **cs.attn_held(got, want, route)})
            del q, k, v, got, want
            torch.cuda.empty_cache()
    reading = {"attention": attention}
    if "wgmma" in routes:
        model, params, prompts = cs.twin_model(qwen2_5_3b.make_config(), bf16, dev)
        l_k, _ = tr.prefill(params, prompts, model, 2048 + 16, device=dev)
        l_p, _ = tr.prefill(params, prompts, model, 2048 + 16, device=dev, use_kernel=False)
        atol, rtol = cs.LOGIT_TOL[bf16]
        reading["twin_bfloat16"] = {
            "logits_max_abs_err": cs.max_abs_err(l_k, l_p), "atol": atol, "rtol": rtol,
            "ok": bool(((l_k.float() - l_p.float()).abs()
                        <= atol + rtol * l_p.float().abs()).all())}
    return reading


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", help="where the copies go (default: a new temporary directory)")
    ap.add_argument("--measure", nargs="+", choices=sorted(SHAPES), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("k6_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = args.workdir or tempfile.mkdtemp(prefix="k6_faults_")
    bad = []
    try:
        for name, (route, edits) in FAULTS.items():
            copy = os.path.join(work, name)
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for rel in ("chip_smoke.py", os.path.join("tools", "k6_planted_faults.py")):
                os.makedirs(os.path.dirname(os.path.join(copy, rel)), exist_ok=True)
                shutil.copy(os.path.join(ROOT, rel), os.path.join(copy, rel))
            plant(copy, edits)
            script = os.path.join(copy, "tools", "k6_planted_faults.py")
            routes = sorted(SHAPES) if route is None else [route]
            run = subprocess.run([sys.executable, script, "--measure", *routes],
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                print(json.dumps({"variant": name, "returncode": run.returncode}), flush=True)
                bad.append(name)
                continue
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name, **reading}), flush=True)
            passed = [all(a[bound]["ok"] for bound in ("tol", "ulps"))
                      for a in reading["attention"]]
            if (not all(passed)) if name == "intact" else any(passed):
                bad.append(name)
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)
    if bad:
        print(f"k6_planted_faults: not as expected: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
