"""xDeepFM (Lian et al., arXiv:1803.05170): CIN + DNN + linear over sparse
feature embeddings, and the `retrieval_cand` scoring of one query against the
item table with the K5 top-k kernel.

Port of ``repro/models/recsys.py`` (forward, ``loss_fn`` and retrieval).
Parameters are a dict of tensors in the JAX package's
layout: ``tables`` (F, rows, D), ``lin_tables`` (F, rows), ``cin`` a list of
(H_k, H_{k-1}, F), ``mlp`` a list of {w, b}, ``out_cin`` (sum H, 1), ``bias``.
Embedding gathers, the CIN contractions, the MLP and the scoring product are
plain torch, as they were XLA outside any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import mlp_apply, mlp_init, normal, tree_from_numpy
from repro_torch.tree import tree_map

# largest (rows, H, F, D) CIN interaction tensor built at once
_CIN_TEMP_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    table_rows: int = 100_000       # rows per field table
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    multi_hot_fields: int = 4       # first fields take bags, rest single-hot
    bag_size: int = 3
    param_dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# EmbeddingBag: gather + masked sum (multi-hot)
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """table (R, D); indices (B, bag) integer (-1 = pad) -> (B, D)."""
    emb = table[indices.clamp_min(0).long()]
    mask = (indices >= 0).to(emb.dtype)[..., None]
    summed = (emb * mask).sum(dim=-2)
    if mode == "mean":
        summed = summed / mask.sum(dim=-2).clamp_min(1.0)
    return summed


def embedding_bag_ragged(table: torch.Tensor, flat_indices: torch.Tensor,
                         bag_ids: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Ragged form: flat (N,) indices with their bag ids -> (n_bags, D) sums."""
    emb = table[flat_indices.long()]
    out = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    return out.index_add_(0, bag_ids.long(), emb)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_params(cfg: XDeepFMConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters of the JAX package's shapes and scales, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    f, d, dt = cfg.n_sparse, cfg.embed_dim, cfg.param_dtype
    tables = normal(gen, (f, cfg.table_rows, d), 0.01, dt)
    lin_tables = normal(gen, (f, cfg.table_rows), 0.01, dt)
    cin = []
    h_prev = f
    for h in cfg.cin_layers:
        cin.append(normal(gen, (h, h_prev, f), (h_prev * f) ** -0.5, dt))
        h_prev = h
    mlp = mlp_init(gen, [f * d, *cfg.mlp_layers, 1], dt)
    out_cin = normal(gen, (sum(cfg.cin_layers), 1), sum(cfg.cin_layers) ** -0.5, dt)
    return {"tables": tables, "lin_tables": lin_tables, "cin": cin, "mlp": mlp,
            "out_cin": out_cin, "bias": torch.zeros((), dtype=dt, device=gen.device)}


def params_from_numpy(tree: dict, cfg: XDeepFMConfig, device="cuda") -> dict:
    """The JAX package's ``init_params`` tree, as numpy arrays, as this
    module's parameters on ``device`` (the layouts are the same)."""
    params = tree_from_numpy(tree, resolve_device(device))
    if tuple(params["tables"].shape) != (cfg.n_sparse, cfg.table_rows, cfg.embed_dim):
        raise ValueError(f"tables {tuple(params['tables'].shape)} do not fit {cfg.name}")
    return params


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_numpy``: the parameters as numpy arrays in
    the JAX package's tree (the layouts are the same)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def _sparse_ids(params, batch, dev) -> torch.Tensor:
    check_on(params["tables"], dev, "parameters")
    return torch.as_tensor(batch["sparse_ids"], device=params["tables"].device)


def _embed_fields(params, ids: torch.Tensor):
    """ids (B, F, bag) integer, -1 padded -> field embeddings (B, F, D) and
    linear terms (B, F)."""
    f = params["tables"].shape[0]
    field = torch.arange(f, device=ids.device)[None, :, None]
    safe = ids.clamp_min(0).long()
    mask = (ids >= 0).to(params["tables"].dtype)
    emb = (params["tables"][field, safe] * mask[..., None]).sum(dim=2)
    lin = (params["lin_tables"][field, safe] * mask).sum(dim=-1)
    return emb, lin


def _cin_rows(params, x0: torch.Tensor) -> torch.Tensor:
    xk = x0
    outs = []
    for w in params["cin"]:
        z = torch.einsum("bid,bjd->bijd", xk, x0)
        xk = torch.einsum("bijd,hij->bhd", z, w.to(z.dtype))
        outs.append(xk.sum(dim=-1))  # (B, H)
    return torch.cat(outs, dim=-1)


def _cin(params, x0: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """Compressed Interaction Network. x0 (B, F, D) -> (B, sum(H)).

    The interaction tensor z (B, H_{k-1}, F, D) of the JAX form is 8.2 GB per
    layer in float32 at the serve_bulk batch (B = 262,144, H = 200, F = 39,
    D = 10), so the batch goes through in chunks of rows whose z stays under
    1 GiB. Rows are independent, so this is the same function (the product's
    summation order may follow the chunk's shape).
    """
    b, f, d = x0.shape
    widest = max([f, *cfg.cin_layers])
    step = max(1, _CIN_TEMP_BYTES // (widest * f * d * x0.element_size()))
    if torch.is_grad_enabled() and (x0.requires_grad
                                    or any(w.requires_grad for w in params["cin"])):
        # when autograd records, each chunk's z would be kept for the backward
        # (20 GB a layer at launch/train.py's training batch of 65,536): the
        # backward recomputes it instead, chunk by chunk (the same values).
        # Inference (nothing requires grad) takes the plain loop below.
        return torch.cat([torch.utils.checkpoint.checkpoint(
            _cin_rows, params, x0[r0 : r0 + step], use_reentrant=False)
            for r0 in range(0, b, step)])
    return torch.cat([_cin_rows(params, x0[r0 : r0 + step]) for r0 in range(0, b, step)])


def forward(params, batch, cfg: XDeepFMConfig, *, device="cuda") -> torch.Tensor:
    """batch['sparse_ids'] (B, F, bag) -> logits (B,)."""
    ids = _sparse_ids(params, batch, resolve_device(device))
    emb, lin = _embed_fields(params, ids)
    b = emb.shape[0]
    cin_feat = _cin(params, emb, cfg)
    dnn = mlp_apply(params["mlp"], emb.reshape(b, -1))
    return (
        dnn[:, 0]
        + (cin_feat @ params["out_cin"].to(cin_feat.dtype))[:, 0]
        + lin.sum(dim=-1)
        + params["bias"].to(emb.dtype)
    )


def loss_fn(params, batch, cfg: XDeepFMConfig, *, device="cuda") -> torch.Tensor:
    """Mean binary cross entropy of the logits against ``batch['labels']``
    (B,) in {0, 1}, in float32, in the stable form max(x, 0) - x y +
    log1p(exp(-|x|))."""
    logit = forward(params, batch, cfg, device=device).to(torch.float32)
    y = torch.as_tensor(batch["labels"], device=logit.device).to(torch.float32)
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def retrieval_score(params, batch, cfg: XDeepFMConfig, k: int = 100, *, device="cuda",
                    use_kernel: bool = True):
    """`retrieval_cand`: one query against ``batch['n_candidates']`` items,
    exact top-k: ((1, k) int32 item ids, (1, k) scores).

    Query embedding = sum of the query's field embeddings; candidates are the
    first rows of field 0's table (the item table); scoring is one product,
    selection the K5 kernel (``ops.retrieval_topk``).
    """
    ids = _sparse_ids(params, batch, resolve_device(device))
    emb, _ = _embed_fields(params, ids)  # (1, F, D)
    q = emb.sum(dim=1)  # (1, D)
    cand = params["tables"][0, : batch["n_candidates"]]  # (N, D)
    scores = q @ cand.T.to(q.dtype)  # (1, N)
    return ops.retrieval_topk(scores, k, use_kernel=use_kernel)
