"""Training steps of the side models on one device: the port of
``make_lm_train``, ``make_recsys_train``, ``GNN_MODULES`` and
``make_gnn_train`` (``repro/train/steps.py``).

Each returns ``train_step(params, opt_state, batch) -> (params, opt_state,
{"loss", "grad_norm"})``: the family's ``loss_fn`` and its gradient by
autograd (the JAX package's ``value_and_grad``), then ``adamw.update``. The
parameters and moments are updated in place (``adamw.update``) and returned;
``loss`` and ``grad_norm`` are float32 scalar tensors on the parameters'
device. The JAX builders also return sharding trees (for the GNNs
``gnn_batch_specs``: edges over every mesh axis, nodes over the data axes or,
with ``node_shard="all"``, over all of them); those only place arrays on a
mesh and have no counterpart on one card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.models import recsys as rec
from repro_torch.models import transformer as tr
from repro_torch.models.gnn import egnn as egnn_mod
from repro_torch.models.gnn import gcn as gcn_mod
from repro_torch.models.gnn import mace as mace_mod
from repro_torch.models.gnn import nequip as nequip_mod
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map

GNN_MODULES = {
    "gcn-cora": gcn_mod,
    "egnn": egnn_mod,
    "nequip": nequip_mod,
    "mace": mace_mod,
}


def _train_step(loss_of: Callable, opt_cfg: adamw.AdamWConfig) -> Callable:
    """The train step of ``loss_of(params, batch)``."""

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = loss_of(params, batch)
        # a leaf the loss does not reach (egnn's last coordinate MLP) gets a
        # zero gradient, as under JAX's value_and_grad
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                         materialize_grads=True))
        grad_tree = tree_map(lambda _: next(grads), params)  # leaves order
        params, opt_state, gnorm = adamw.update(grad_tree, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_lm_train(cfg: tr.TransformerConfig, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                  *, device="cuda", use_kernel: bool = True) -> Callable:
    """The LM train step: token-mean cross entropy of ``tr.forward`` (K6 in its
    attention on the card) against ``batch['labels']``."""
    return _train_step(lambda params, batch: tr.loss_fn(params, batch, cfg, device=device,
                                                        use_kernel=use_kernel), opt_cfg)


def make_recsys_train(cfg: rec.XDeepFMConfig,
                      opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
                      device="cuda") -> Callable:
    """The xDeepFM train step: mean binary cross entropy of ``rec.forward``."""
    return _train_step(lambda params, batch: rec.loss_fn(params, batch, cfg, device=device),
                       opt_cfg)


def make_gnn_train(arch_id: str, cfg, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
                   device="cuda") -> Callable:
    """The train step of a GNN (``GNN_MODULES[arch_id]``): its ``loss_fn``
    (energy MSE or node cross entropy) on a batch of tensors on ``device``."""
    mod = GNN_MODULES[arch_id]
    dev = resolve_device(device)

    def loss_of(params, batch):
        check_on(batch["edge_index"], dev, "the batch's edges")
        return mod.loss_fn(params, batch, cfg)

    return _train_step(loss_of, opt_cfg)
