"""End-to-end training driver of the port: data pipeline -> train step (K6 in
the LM's attention on the card) -> checkpoint/resume -> step timer. The twin
of ``repro/launch/train.py``: the same flags and printed lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20 [--device cpu]

Families: ``lm`` (granite-moe-1b-a400m, llama4-scout-17b-a16e, qwen2.5-3b,
internlm2-20b, qwen1.5-110b), ``recsys`` (xdeepfm) and ``gnn`` (gcn-cora,
egnn, nequip, mace). Without ``--smoke`` the streams have the JAX driver's
full shapes (LM batch 256 x 4,096 tokens, recsys batch 65,536, GNN the
``molecule`` config on 128 graphs of 12 nodes and 32 edges), which the JAX
package runs on a mesh; on one card the full LM shapes do not fit
(``chip_smoke.py``'s ``train`` phase trains the full qwen2.5-3b and
granite-moe-1b-a400m at batch 1 x 2,048 through ``train.steps`` instead).
Initial parameters come from the port's seeded generators (seed 0), so the
losses differ from the JAX driver's; the step function is what the tests
hold to JAX. Checkpoints are the JAX driver's tree, ``(params, opt_state)``
with the LM's layers stacked, so either package resumes from the other's
directory. Runs on the GPU by default and fails without one; ``--device
cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import StepTimer
from repro_torch.models import recsys as rc
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod


def make_stream(arch, cfg, smoke: bool):
    if arch.family == "lm":
        b, s = (8, 64) if smoke else (256, 4096)
        return pipeline.LMStream(vocab=cfg.vocab, batch=b, seq=s)
    if arch.family == "recsys":
        b = 32 if smoke else 65536
        return pipeline.RecsysStream(
            n_sparse=cfg.n_sparse, bag=cfg.bag_size, rows=cfg.table_rows, batch=b
        )
    if arch.family == "gnn":
        b = 8 if smoke else 128
        return pipeline.GraphStream(n_nodes=12, n_edges=32, batch=b, d_feat=cfg.d_feat)
    raise ValueError(arch.family)


def _lm_to_ckpt(params, opt_state):
    """The JAX driver's checkpoint tree of the LM: the layers of the
    parameters and both moments stacked, on the host (a stacked copy on the
    card would be as large as all three)."""
    stack = lambda tree: tr.stack_layers(tree, device="cpu")
    return stack(params), {**opt_state, "m": stack(opt_state["m"]), "v": stack(opt_state["v"])}


def _lm_locate(path: tuple) -> tuple[tuple, int | None]:
    """The stored key path and row of an LM leaf: ``layers[i][name][key]``
    is row i of the checkpoint's ``layers/name/key``."""
    at = path.index("layers") if "layers" in path else -1
    if at < 0:
        return path, None
    return path[:at + 1] + path[at + 2:], path[at + 1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    device = resolve_device(args.device)
    if arch.family == "gnn":
        cfg = arch.make_smoke() if args.smoke else arch.make_config("molecule")
    else:
        cfg = arch.make_smoke() if args.smoke else arch.make_config()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=max(args.steps, 10))

    stream = make_stream(arch, cfg, args.smoke)
    if arch.family == "lm":
        fn = steps_mod.make_lm_train(cfg, opt_cfg, device=device)
        init = lambda: tr.init_params(cfg, seed=0, device=device)
        to_ckpt, locate = _lm_to_ckpt, _lm_locate
    elif arch.family == "recsys":
        fn = steps_mod.make_recsys_train(cfg, opt_cfg, device=device)
        init = lambda: rc.init_params(cfg, seed=0, device=device)
        to_ckpt, locate = (lambda p, o: (p, o)), None
    else:  # gnn (make_stream refused the other families)
        fn = steps_mod.make_gnn_train(arch.arch_id, cfg, opt_cfg, device=device)
        mod = steps_mod.GNN_MODULES[arch.arch_id]
        init = lambda: mod.init_params(cfg, seed=0, device=device)
        to_ckpt, locate = (lambda p, o: (p, o)), None

    params = init()
    opt_state = adamw.init(params)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step = ckpt.restore(args.ckpt_dir, (params, opt_state),
                                                       locate=locate)
        print(f"resumed from step {start_step}")

    timer = StepTimer()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.monotonic()
        batch = {key: torch.from_numpy(val).to(device)
                 for key, val in stream.batch_at(step).items()}
        params, opt_state, metrics = fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        timer.update(time.monotonic() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {timer.mean:.3f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, to_ckpt(params, opt_state))
            ckpt.prune(args.ckpt_dir)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, to_ckpt(params, opt_state))
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
