"""Times granite-moe-1b-a400m's prefill (full, bf16, batch 4 x 2,048,
weights from seed 0) in one process, each way ``chip_smoke.py`` reads it.

    python3 tools/granite_prefill.py [--src DIR]

Twice: ``serve.generate`` as ``launch/serve.py`` times it (the host
clock from the prefill's start to the synchronize after its first token),
then ``chip_smoke.prefill_split`` (CUDA events around each K6 call and each
MoE FFN, the host time to enqueue the prefill, and the same prefill with no
events around the calls). ``--src`` names the ``src`` directory that
``repro_torch`` is imported from (this checkout's by default), so that
another commit's port, unpacked beside this one, is timed in the same call
through this checkout's ``chip_smoke.py``; its kernels build beside that
``src``.

Needs one CUDA card. Prints the card's name and power limit, then one JSON
line per read.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, ROOT]
    import repro_torch  # first, from --src: chip_smoke's own path entry then finds it imported
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr

    if not torch.cuda.is_available():
        print("granite_prefill: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_arch("granite-moe-1b-a400m").make_config()
    params = tr.init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab, (4, 2048), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    for rep in range(READS):
        run = serve.generate(params, prompts, cfg, 2, device=dev)
        print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__), "rep": rep,
                          "serve_prefill_ms": run["prefill_s"] * 1e3,
                          "k6_launches": run["launches"]["flash_attention"],
                          "split": cs.prefill_split(cfg, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
