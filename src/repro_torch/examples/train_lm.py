"""End-to-end LM training: train a transformer for a few hundred steps on a
learnable Markov stream and watch the loss fall toward the chain's entropy.
The port's twin of the JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm                  # ~15M params
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full --steps 300  # ~100M params

Uses the step builder and optimizer of ``launch/train.py``
(``train.steps.make_lm_train``, AdamW): on the card the attention's forward
is the K6 kernel at the config's head dim (32 for lm-15m, 64 for lm-100m).
Runs on the GPU by default and fails without one; ``--device cpu`` runs the
plain versions. Fails unless the loss falls by at least 0.5.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch.data.pipeline import MarkovLMStream
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--full", action="store_true", help="~100M-param config")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full:
        cfg = tr.TransformerConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab=8192, param_dtype=torch.float32,
        )
    else:
        cfg = tr.TransformerConfig(
            name="lm-15m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
            d_head=32, d_ff=512, vocab=512, param_dtype=torch.float32,
        )
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")

    branching = 4
    stream = MarkovLMStream(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                            branching=branching)
    print(f"target loss (chain entropy) = ln({branching}) = {math.log(branching):.3f}")

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                                weight_decay=0.01)
    step_fn = steps_mod.make_lm_train(cfg, opt_cfg, device=device)

    params = tr.init_params(cfg, seed=0, device=device)
    opt_state = adamw.init(params)
    ops.reset_launches()
    t0 = time.time()
    first = None
    for step in range(args.steps):
        batch = {key: torch.from_numpy(val).to(device)
                 for key, val in stream.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {loss:.4f}  ({time.time() - t0:.0f}s)")
    print(f"\nloss: {first:.3f} -> {loss:.3f} "
          f"(entropy floor {math.log(branching):.3f})")
    stats = {"model": cfg.name, "device": str(device), "steps": args.steps,
             "first_loss": first, "loss": loss, "seconds": time.time() - t0,
             "launches": ops.launches()}
    print(json.dumps(stats))
    if not loss < first - 0.5:
        raise SystemExit("training should clearly reduce loss")
    return stats


if __name__ == "__main__":
    main()
