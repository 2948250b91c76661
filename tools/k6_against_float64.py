"""Holds K6's bf16 wgmma route and its plain version to a float64 attention.

    python3 tools/k6_against_float64.py

At (4, 2048, H/Hkv, D) causal bf16 for the LMs' head layouts (16/2
qwen2.5-3b, 16/8, 40/8 llama4-scout, 48/8 internlm2-20b, 64/8 qwen1.5-110b at
D = 128; 16/8 granite-moe-1b-a400m at D = 64),
on inputs from a seeded generator, computes K6, the plain version with its
default 1,024-row kv blocks and at the kernel's own kv tile of 128
(``chip_smoke.attn_plain``), and the attention in float64 from the same bf16
inputs. For each layout it prints one JSON line: the wgmma route's
per-element bound (``chip_smoke.attn_held``) of K6 against either plain
version (ratio, outputs outside it), and each of the three's mean and largest
|error| against float64. It shows which side of a failed bound is the
farther from the exact attention.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit
first. Exits 0; it checks nothing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ((16, 2, 128), (16, 8, 128), (40, 8, 128), (48, 8, 128), (64, 8, 128),
           (16, 8, 64))


def attention_f64(q, k, v):
    """Causal attention in float64 from bf16 q (B, S, H, D), k and v (B, S,
    Hkv, D), one (batch, kv head) at a time."""
    import torch

    b, s, h, d = q.shape
    rep = h // k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for i in range(b):
        for g in range(k.shape[2]):
            heads = slice(g * rep, (g + 1) * rep)
            sc = torch.einsum("srd,td->rst", q[i, :, heads].double(), k[i, :, g].double()) * d**-0.5
            p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
            out[i, :, heads] = torch.einsum("rst,td->srd", p, v[i, :, g].double())
    return out


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    if not torch.cuda.is_available():
        print("k6_against_float64: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    for h, hkv, d in LAYOUTS:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((4, 2048, h, d), (4, 2048, hkv, d), (4, 2048, hkv, d)))
        got = ops.flash_attention(q, k, v, causal=True)
        plain = {"plain_1024": ref.flash_attention_ref(q, k, v, causal=True),
                 "plain_tile": cs.attn_plain(q, k, v, causal=True)}
        exact = attention_f64(q, k, v)
        line = {"layout": f"(4, 2048, {h}/{hkv}, {d}) causal bf16"}
        for name, want in plain.items():
            held = cs.attn_held(got, want, "wgmma")["ulps"]
            line[f"k6_vs_{name}"] = {key: held[key] for key in ("ratio", "outside")}
        for name, out in (("k6", got), *plain.items()):
            err = (out.double() - exact).abs()
            line[f"{name}_vs_f64"] = {"mean": float(err.mean()), "max": float(err.max())}
        print(json.dumps(line), flush=True)
        del q, k, v, got, plain, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
