"""Shared GNN substrate: message passing by segment reductions, the port of
``repro/models/gnn/common.py``.

Messages are gathered by edge index, transformed and summed into their
destination nodes with ``index_add`` along the node dimension, with the
streams' int32 indices as they come. The MLPs are
``repro_torch.models.common``'s ``mlp_init`` / ``mlp_apply``.

Where the port and JAX part on indices (each pinned by a test):
- ``take_rows`` clamps an out-of-range row id as JAX's gather does
  (``params["encoder"][batch["species"]]``), and its gradient drops such
  ids as JAX's does: the drivers' molecule stream draws species in [0, 16)
  for configs with fewer species.
- A destination id outside [0, n) is dropped by JAX's ``segment_sum``; here
  ``index_add`` raises for it (a device assert on the card). No stream of
  the repo makes one: padded subgraphs aim their dummy edges at the last
  node.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Row ``v`` of the result is the sum of the messages with ``dst == v``."""
    out = messages.new_zeros((n_nodes,) + tuple(messages.shape[1:]))
    return out.index_add(0, dst, messages)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(messages, dst, n_nodes)
    cnt = degree(dst, n_nodes, messages.dtype)
    return s / torch.clamp(cnt, min=eps)[:, None]


def degree(dst: torch.Tensor, n_nodes: int, dtype=torch.float32) -> torch.Tensor:
    ones = torch.ones(dst.shape, dtype=dtype, device=dst.device)
    return scatter_sum(ones, dst, n_nodes)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's index semantics: a negative id counts from
    the end, then every id is clamped into [0, rows) (XLA's gather). Its
    gradient is XLA's scatter, which drops the ids that were out of range:
    no row receives the gradient of a clamped read."""
    rows = table.shape[0]
    ids = torch.where(ids < 0, ids + rows, ids)
    out = table[torch.clamp(ids, 0, rows - 1)]
    in_range = ((ids >= 0) & (ids < rows)).reshape(ids.shape + (1,) * (out.ndim - ids.ndim))
    return torch.where(in_range, out, out.detach())


def task_loss(out: torch.Tensor, batch: dict, task: str) -> torch.Tensor:
    """The four architectures' loss on their per-node output: ``energy`` is
    the mean squared error of the per-graph sums of ``out[:, 0]`` against
    ``graph_targets``, ``node_class`` the mean cross entropy of ``out``
    (float32 log-softmax) against ``labels``."""
    if task == "energy":
        n_graphs = batch["graph_targets"].shape[0]
        energy = scatter_sum(out[:, 0], batch["graph_id"], n_graphs)
        err = energy - batch["graph_targets"]
        return torch.mean(err * err)
    lg = F.log_softmax(out.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(lg, 1, batch["labels"].long()[:, None]))
