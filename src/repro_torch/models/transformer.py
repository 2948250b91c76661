"""Decoder-only transformer, dense or MoE FFN, GQA, QKV bias, RoPE, KV cache:
the port of ``repro/models/transformer.py`` (forward, ``loss_fn``, prefill,
decode) for the five LM configurations (granite-moe-1b-a400m,
llama4-scout-17b-a16e, qwen2.5-3b, internlm2-20b, qwen1.5-110b).

Parameters are a dict of tensors in the JAX package's layout, with the layers
as a list of per-layer dicts (the JAX package stacks them on a leading axis
for ``lax.scan``; a Python loop runs them here, and each layer's leaves stay
separate tensors, so autograd accumulates each gradient in place of a
gradient of the whole stack). ``stack_layers`` / ``unstack_layers`` convert
to and from the stacked tree (checkpoints, comparisons with JAX). The
attention of ``forward`` and ``prefill`` is ``nn.attention``, the K6 kernel
on the card (differentiable: the backward is the plain attention's);
``decode_step``
keeps the JAX package's grouped product against the cache in plain torch. The
cache is updated in place (the JAX package returns a new one): ``prefill``
makes it, each ``decode_step`` writes one position of it and returns it.

MoE layers (``n_experts > 0``) route with the JAX package's sort-based
capacity scheme (``_moe_ffn``): no (tokens, E, C) one-hot, grouped expert
products in the activations' type, and a combine that sums each token's
contributions in a fixed order, so two calls on the card give the same bits.
The JAX config's ``q_chunk``, ``kv_chunk``, ``attn_probs_bf16``,
``remat_policy`` and ``moe_ep_constraint`` are XLA tiling, rematerialisation
and mesh-sharding knobs; on one card K6 picks its own tiles and nothing is
sharded, so the port's config leaves them out.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.analysis import sanitize
from repro_torch.device import check_on, generator, resolve_device
from repro_torch.models import nn
from repro_torch.models.common import normal, tree_from_numpy
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def _attn_count(self) -> int:
        d, hd = self.d_model, self.d_head
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def param_count(self) -> int:
        """Weights of the projections, FFN (every expert and the router) and
        embeddings (the JAX package's count: biases and norm gains left out)."""
        d = self.d_model
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (self._attn_count() + ffn) + 2 * self.vocab * d

    def active_param_count(self) -> int:
        """The weights one token goes through: ``moe_top_k`` experts of each
        MoE layer, the router left out (the JAX package's count)."""
        ffn = 3 * self.d_model * self.d_ff * (self.moe_top_k if self.is_moe else 1)
        return self.n_layers * (self._attn_count() + ffn) + 2 * self.vocab * self.d_model


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales, drawn on
    ``device`` from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    dt = cfg.param_dtype
    d, hd = cfg.d_model, cfg.d_head

    def layer():
        p = {
            "ln1": nn.rmsnorm_init(d, dt, device=dev),
            "wq": nn.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dt),
            "wk": nn.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dt),
            "wv": nn.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dt),
            "wo": nn.dense_init(gen, cfg.n_heads * hd, d, dtype=dt),
            "ln2": nn.rmsnorm_init(d, dt, device=dev),
        }
        if cfg.is_moe:
            # the JAX package's layout: a float32 router, bare (E, d, f) and
            # (E, f, d) expert tensors
            e, f = cfg.n_experts, cfg.d_ff
            std = 1.0 / math.sqrt(d)
            p["router"] = {"w": normal(gen, (d, e), std, torch.float32)}
            p["w_gate"] = normal(gen, (e, d, f), std, dt)
            p["w_up"] = normal(gen, (e, d, f), std, dt)
            p["w_down"] = normal(gen, (e, f, d), 1.0 / math.sqrt(f), dt)
        else:
            p["w_gate"] = nn.dense_init(gen, d, cfg.d_ff, dtype=dt)
            p["w_up"] = nn.dense_init(gen, d, cfg.d_ff, dtype=dt)
            p["w_down"] = nn.dense_init(gen, cfg.d_ff, d, dtype=dt)
        return p

    layers = [layer() for _ in range(cfg.n_layers)]
    emb_std = 1.0 / math.sqrt(d)
    return {
        "embed": normal(gen, (cfg.vocab, d), emb_std, dt),
        "layers": layers,
        "ln_f": nn.rmsnorm_init(d, dt, device=dev),
        "unembed": normal(gen, (d, cfg.vocab), emb_std, dt),
    }


def stack_layers(params: dict, device=None) -> dict:
    """This module's parameters (or a tree shaped like them, such as the
    optimizer's moments) in the JAX package's layout: each layer leaf (in a
    dict, as ``wq``'s, or bare, as an MoE layer's ``w_gate``) stacked on a
    leading (L,) axis, built on ``device`` (default: the leaves' own). New
    tensors; the others are shared."""
    def stack(*rows):
        return torch.stack([r.detach().to(device or r.device) for r in rows])

    return {**params, "layers": tree_map(stack, *params["layers"])}


def unstack_layers(tree: dict) -> dict:
    """The inverse of ``stack_layers``: one dict per layer, each leaf its own
    tensor (a copy, not a view of the stack)."""
    stacked = tree["layers"]
    layers = [tree_map(lambda arr: arr[i].clone(), stacked)
              for i in range(len(stacked["ln1"]["g"]))]
    return {**tree, "layers": layers}


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: the parameters as numpy arrays in
    the JAX package's tree, layers stacked. bfloat16 leaves come out as
    float32 (exactly; numpy has no bfloat16 of its own)."""
    def to_np(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return tree_map(to_np, stack_layers(params))


def params_from_numpy(tree: dict, cfg: TransformerConfig, device="cuda") -> dict:
    """The JAX package's ``init_params`` tree, as numpy arrays (layers stacked
    on a leading axis), as this module's parameters on ``device``."""
    n = len(tree["layers"]["ln1"]["g"])
    if n != cfg.n_layers:
        raise ValueError(f"{n} layers in the tree, {cfg.name} has {cfg.n_layers}")
    return unstack_layers(tree_from_numpy(tree, resolve_device(device)))


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------


def _moe_route(lp, x2d: torch.Tensor, cfg: TransformerConfig):
    """The router over tokens x2d (N, d), in float32: (gates (N, k) float32,
    experts (N, k) int64), the top ``moe_top_k`` probabilities a token,
    ties to the lower expert index as ``lax.top_k`` breaks them (a stable
    descending sort), renormalised to sum 1."""
    probs = torch.softmax(x2d.to(torch.float32) @ lp["router"]["w"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top_p[:, :cfg.moe_top_k], top_e[:, :cfg.moe_top_k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx


def _moe_dispatch(lp, x2d: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Each expert's SwiGLU over at most ``cap`` of the tokens routed to it
    (``gates``, ``eidx`` from ``_moe_route``), in the order of a stable sort
    by expert; assignments past ``cap`` go to a pad slot and add 0. Each
    token's contributions, scaled by their gates in x2d's type, are summed
    one by one in expert order (the order of JAX's scatter-add), with no
    atomics: the same bits every call."""
    n_tok, d = x2d.shape
    e, kk = cfg.n_experts, cfg.moe_top_k
    dev = x2d.device
    cap = int(math.ceil(n_tok * kk / e * cfg.capacity_factor))
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, sg = flat_e[order], gates.reshape(-1)[order]
    st = order // kk  # the token of each assignment, in dispatch order
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(n_tok * kk, device=dev) - starts[se]
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e * cap)  # e * cap: the pad slot

    grouped = x2d.new_zeros((e * cap + 1, d))
    grouped[dest] = x2d[st]
    grouped = grouped[:-1].reshape(e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", grouped, lp["w_gate"].to(x2d.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", grouped, lp["w_up"].to(x2d.dtype))
    y = torch.einsum("ecf,efd->ecd", h, lp["w_down"].to(x2d.dtype))
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    contrib = y_flat[dest] * (sg * keep).to(y.dtype)[:, None]

    # the combine: each token's k dispatch positions, ascending (its experts
    # in index order), gathered back and summed in that order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_tok * kk, device=dev)
    parts = contrib[torch.sort(inv.reshape(n_tok, kk), dim=-1).values]  # (N, k, d)
    out = parts[:, 0]
    for j in range(1, kk):
        out = out + parts[:, j]
    return out


def _moe_ffn(lp, x2d: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The MoE FFN over tokens x2d (N, d): ``_moe_route``, then
    ``_moe_dispatch`` (the JAX package's sort-based capacity routing, no
    (tokens, E, C) one-hot). No host round trip: under ``REPRO_SANITIZE=1``
    it runs inside the sync guard."""
    with sanitize.guard("moe_ffn"):
        return _moe_dispatch(lp, x2d, *_moe_route(lp, x2d, cfg), cfg)


def _dense_ffn(lp, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(nn.dense_apply(lp["w_gate"], x)) * nn.dense_apply(lp["w_up"], x)
    return nn.dense_apply(lp["w_down"], h)


def _ffn(lp, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The layer's FFN over x (..., d): MoE over its tokens, or dense."""
    if cfg.is_moe:
        return _moe_ffn(lp, x.reshape(-1, x.shape[-1]), cfg).reshape(x.shape)
    return _dense_ffn(lp, x)


def _attn_proj(lp, x, cfg: TransformerConfig, pos):
    b, s, _ = x.shape
    hd = cfg.d_head
    q = nn.dense_apply(lp["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = nn.dense_apply(lp["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = nn.dense_apply(lp["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    return nn.apply_rope(q, pos, cfg.rope_theta), nn.apply_rope(k, pos, cfg.rope_theta), v


def _layer_fwd(lp, x, cfg: TransformerConfig, pos, use_kernel: bool):
    """One layer over a whole sequence (causal); returns (x, k, v)."""
    b, s, _ = x.shape
    q, k, v = _attn_proj(lp, nn.rmsnorm_apply(lp["ln1"], x), cfg, pos)
    o = nn.attention(q, k, v, causal=True, use_kernel=use_kernel)
    x = x + nn.dense_apply(lp["wo"], o.reshape(b, s, cfg.n_heads * cfg.d_head))
    return x + _ffn(lp, nn.rmsnorm_apply(lp["ln2"], x), cfg), k, v


def _tokens(params, tokens, dev) -> torch.Tensor:
    check_on(params["embed"], dev, "parameters")
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm_apply(params["ln_f"], x)
    return x @ params["unembed"].to(x.dtype)


def forward(params, tokens, cfg: TransformerConfig, *, device="cuda",
            use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V)."""
    tok = _tokens(params, tokens, resolve_device(device))
    x = params["embed"].to(cfg.param_dtype)[tok]
    pos = torch.arange(tok.shape[1], device=tok.device)
    for lp in params["layers"]:
        x, _, _ = _layer_fwd(lp, x, cfg, pos, use_kernel)
    return _logits(params, x)


def loss_fn(params, batch, cfg: TransformerConfig, *, device="cuda",
            use_kernel: bool = True) -> torch.Tensor:
    """Token-mean cross entropy of ``forward(batch['tokens'])`` against
    ``batch['labels']`` (both (B, S) integer)."""
    logits = forward(params, batch["tokens"], cfg, device=device, use_kernel=use_kernel)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    return nn.cross_entropy(logits, labels)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Zeroed (L, B, max_len, Hkv, D) K and V caches in the parameters' type;
    ``len`` is the number of positions written (a host integer)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev), "len": 0}


def prefill(params, tokens, cfg: TransformerConfig, max_len: int, *, device="cuda",
            use_kernel: bool = True):
    """Run the prompt (B, S) through the model: (last-position logits (B, V),
    cache with the prompt's K and V in positions 0..S-1)."""
    tok = _tokens(params, tokens, resolve_device(device))
    b, s = tok.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    x = params["embed"].to(cfg.param_dtype)[tok]
    pos = torch.arange(s, device=tok.device)
    cache = init_cache(cfg, b, max_len, device=tok.device)
    for li, lp in enumerate(params["layers"]):
        x, k, v = _layer_fwd(lp, x, cfg, pos, use_kernel)
        cache["k"][li, :, :s] = k
        cache["v"][li, :, :s] = v
    cache["len"] = s
    return _logits(params, x[:, -1:])[:, 0], cache


def decode_step(params, cache: dict, tokens, cfg: TransformerConfig):
    """One autoregressive step on the cache's device: tokens (B,) -> logits
    (B, V); writes position ``cache['len']`` of the cache and advances it."""
    kc_all, vc_all = cache["k"], cache["v"]
    dev = kc_all.device
    tok = _tokens(params, tokens, dev)
    b = tok.shape[0]
    t = kc_all.shape[2]
    cur = cache["len"]
    if cur >= t:
        raise ValueError(f"cache of {t} positions is full")
    x = params["embed"].to(cfg.param_dtype)[tok][:, None, :]  # (B, 1, d)
    pos = torch.tensor([cur], device=dev)
    rep = cfg.n_heads // cfg.n_kv_heads
    mask = (torch.arange(t, device=dev) <= cur)[None, None, None, None, :]
    for li, lp in enumerate(params["layers"]):
        q, k, v = _attn_proj(lp, nn.rmsnorm_apply(lp["ln1"], x), cfg, pos)
        kc, vc = kc_all[li], vc_all[li]
        kc[:, cur] = k[:, 0]
        vc[:, cur] = v[:, 0]
        # the whole cache, masked past the current position; grouped heads,
        # K and V never repeated per query head
        qg = q.reshape(b, 1, cfg.n_kv_heads, rep, cfg.d_head)
        sc = torch.einsum("bqgrd,btgd->bgrqt", qg, kc).to(torch.float32) * cfg.d_head**-0.5
        sc = torch.where(mask, sc, -math.inf)
        w = torch.softmax(sc, dim=-1).to(vc.dtype)
        o = torch.einsum("bgrqt,btgd->bqgrd", w, vc)
        x = x + nn.dense_apply(lp["wo"], o.reshape(b, 1, cfg.n_heads * cfg.d_head))
        x = x + _ffn(lp, nn.rmsnorm_apply(lp["ln2"], x), cfg)
    cache["len"] = cur + 1
    return _logits(params, x)[:, 0], cache
