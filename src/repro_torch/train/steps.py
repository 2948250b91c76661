"""The steps of every cell on one device: the port of
``repro/train/steps.py``.

Training (``make_lm_train``, ``make_recsys_train``, ``make_gnn_train``):
``train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
"grad_norm"})``, the family's ``loss_fn`` and its gradient by autograd (the
JAX package's ``value_and_grad``), then ``adamw.update``. The parameters and
moments are updated in place (``adamw.update``) and returned; ``loss`` and
``grad_norm`` are float32 scalar tensors on the parameters' device.

Serving: ``make_lm_prefill`` and ``make_lm_decode`` (``tr.prefill``,
``tr.decode_step``; K6 in the prefill's attention), ``make_recsys_forward``
and ``make_recsys_retrieval`` (K5), and the paper's own two steps,
``make_knn_build`` (one level of the construction sweep, K1) and
``make_knn_serve`` (a batch of kNN queries, one row gather).

Each factory takes the device its step runs on (the card unless
``device="cpu"``, or ``"meta"`` for the dry run's count), and a step checks
that its inputs lie there. The JAX builders also return sharding trees (for
the GNNs ``gnn_batch_specs``: edges over every mesh axis, nodes over the data
axes or, with ``node_shard="all"``, over all of them) and abstract
arguments; the trees only place arrays on a mesh and have no counterpart on
one card, and ``launch/dryrun.py`` makes the arguments on ``meta``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import ops
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


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def make_lm_prefill(cfg: tr.TransformerConfig, max_len: int, *, device="cuda",
                    use_kernel: bool = True) -> Callable:
    """``prefill_step(params, tokens)``: tokens (B, S) -> (last-position logits
    (B, V), cache of ``max_len`` positions), ``tr.prefill`` with K6 in its
    attention."""
    dev = resolve_device(device)

    def prefill_step(params, tokens):
        return tr.prefill(params, tokens, cfg, max_len, device=dev, use_kernel=use_kernel)

    return prefill_step


def make_lm_decode(cfg: tr.TransformerConfig, cache_batch: int, cache_len: int, *,
                   cache_layout: str = "auto", device="cuda") -> Callable:
    """``decode(params, cache, tokens)``: tokens (cache_batch,) -> (logits
    (cache_batch, V), cache), one ``tr.decode_step`` on a cache of
    (cache_batch, cache_len) positions (``tr.init_cache``). ``cache_layout``
    places the cache on a mesh in the JAX package; only ``"auto"`` has a
    one-card counterpart (the whole cache on the card)."""
    if cache_layout != "auto":
        raise ValueError(f"cache_layout={cache_layout!r} shards the KV cache over a mesh; "
                         "it has no one-card counterpart")
    dev = resolve_device(device)

    def decode(params, cache, tokens):
        check_on(cache["k"], dev, "the cache")
        if tuple(cache["k"].shape[1:3]) != (cache_batch, cache_len):
            raise ValueError(f"a cache of {tuple(cache['k'].shape[1:3])} (batch, positions), "
                             f"the step was made for {(cache_batch, cache_len)}")
        return tr.decode_step(params, cache, tokens, cfg)

    return decode


def make_recsys_forward(cfg: rec.XDeepFMConfig, *, device="cuda") -> Callable:
    """``fwd(params, batch)``: batch['sparse_ids'] (B, F, bag) -> logits (B,)."""
    dev = resolve_device(device)
    return lambda params, batch: rec.forward(params, batch, cfg, device=dev)


def make_recsys_retrieval(cfg: rec.XDeepFMConfig, n_candidates: int, k: int = 100, *,
                          device="cuda", use_kernel: bool = True) -> Callable:
    """``retrieve(params, batch)``: one query (batch['sparse_ids'] (1, F,
    bag)) against the first ``n_candidates`` items -> ((1, k) ids, (1, k)
    scores), ``rec.retrieval_score`` with K5 on the card. (The JAX dry run's
    copy takes the plain form only so that XLA lowers it; the port's count is
    the same either way.)"""
    dev = resolve_device(device)

    def retrieve(params, batch):
        return rec.retrieval_score(params, {**batch, "n_candidates": n_candidates}, cfg, k,
                                   device=dev, use_kernel=use_kernel)

    return retrieve


def make_knn_build(cfg, *, contiguous: bool = False, device="cuda",
                   use_kernel: bool = True) -> Callable:
    """One level of the construction sweep at the dry run's shapes:
    ``step(verts, nbr, w, extra_ids, extra_d, vk_ids, vk_d) -> (vk_ids,
    vk_d)``, rows ``verts`` (S,) of the (rows, k) tables set to the merge of
    their neighbours' rows (``nbr`` (S, T), -1 a padded slot read as the
    last, pad, row; ``w`` (S, T)) and their extras (S, k).

    ``contiguous=True`` is the JAX package's variant for vertices numbered by
    (level, position): ``step(level_start, ...)`` writes the S merged rows as
    the one slice starting at ``level_start`` (a host int; clamped so the
    slice fits, as ``dynamic_update_slice`` clamps it).

    The tables are written in place and returned (the JAX step returns new
    ones, in place under its donation variant); every row read is read
    before any is written.
    """
    dev = resolve_device(device)

    def merged(nbr, w, extra_ids, extra_d, vk_ids, vk_d):
        """Each row's T neighbour k-lists shifted by its edge weights, its k
        extras, and the distinct-id top k of them (K1)."""
        check_on(vk_ids, dev, "the tables")
        s, t = nbr.shape
        valid = nbr >= 0
        nbr_c = torch.where(valid, nbr, vk_ids.shape[0] - 1).long()  # the pad row
        g_ids = torch.where(valid[..., None], vk_ids[nbr_c], -1)
        g_d = w[..., None] + vk_d[nbr_c]
        cand_ids = torch.cat([g_ids.reshape(s, t * cfg.k), extra_ids], dim=1)
        cand_d = torch.cat([g_d.reshape(s, t * cfg.k), extra_d], dim=1)
        return ops.topk_merge(cand_ids, cand_d, cfg.k, use_kernel=use_kernel)

    if contiguous:
        def step(level_start: int, nbr, w, extra_ids, extra_d, vk_ids, vk_d):
            m_ids, m_d = merged(nbr, w, extra_ids, extra_d, vk_ids, vk_d)
            start = min(max(int(level_start), 0), vk_ids.shape[0] - nbr.shape[0])
            vk_ids[start : start + nbr.shape[0]] = m_ids
            vk_d[start : start + nbr.shape[0]] = m_d
            return vk_ids, vk_d

        return step

    def step(verts, nbr, w, extra_ids, extra_d, vk_ids, vk_d):
        m_ids, m_d = merged(nbr, w, extra_ids, extra_d, vk_ids, vk_d)
        rows = verts.long()
        vk_ids[rows] = m_ids
        vk_d[rows] = m_d
        return vk_ids, vk_d

    return step


def make_knn_serve(cfg, *, device="cuda") -> Callable:
    """``serve(vk_ids, vk_d, queries) -> (vk_ids[queries], vk_d[queries])``:
    a batch of kNN queries, each its vertex's row of the tables."""
    dev = resolve_device(device)

    def serve(vk_ids, vk_d, queries):
        check_on(vk_ids, dev, "the tables")
        q = queries.long()
        return vk_ids[q], vk_d[q]

    return serve
