"""AdamW with float32 moments, global-norm clipping and a cosine schedule: the
port's own copy of ``repro/optim/adamw.py``.

Plain functions on trees of tensors (``repro_torch.tree``): the moments
``m`` and ``v`` are float32 trees shaped like the parameters, ``count`` an
int32 scalar tensor. The schedule, the bias corrections ``b ** count`` and the
clip scale are float32 tensors, as JAX computes them (a Python float is
float64 and would part from JAX in the last bit). The update is dense: weight
decay and the moment decay touch every element, every row of an embedding
table included, as in JAX.

``update`` writes the new parameters and moments into the tensors it is given
(the JAX package returns new arrays and its driver donates the old ones): at
the full qwen2.5-3b the float32 moments alone are 27 GB, and a second copy of
them would not fit beside the gradients on one 80 GB card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def init(params) -> dict:
    """Zero float32 moments shaped like ``params``, and ``count`` 0 (int32)."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor): linear warmup, then a
    cosine down to a tenth of ``cfg.lr``; float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - float(cfg.warmup_steps))
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0  # summed leaf by leaf, in tree order, as JAX's sum() does
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def update(grads, state: dict, params, cfg: AdamWConfig):
    """One AdamW step: returns (params, state, grad_norm), the parameters and
    moments updated in place (the same tensors), ``count`` a new tensor."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device) ** cf
    b2c = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device) ** cf
    decay = lr * cfg.weight_decay

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.to(torch.float32)
        step = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step += decay * pf
        p.copy_(pf - step)
        return p

    with torch.no_grad():
        tree_map(upd, grads, state["m"], state["v"], params)
    return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm
