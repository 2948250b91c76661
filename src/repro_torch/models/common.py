"""Shared model pieces: the MLP of the JAX package's GNN substrate
(``repro/models/gnn/common.py``: ``mlp_init``, ``mlp_apply`` with SiLU) and
the carry-over of a parameter tree written as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    """``std`` times a standard normal draw from ``gen`` (float32, on the
    generator's device), cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def mlp_init(gen: torch.Generator, dims: list[int], dtype=torch.float32) -> list[dict]:
    return [
        {"w": normal(gen, (a, b), a**-0.5, dtype),
         "b": torch.zeros((b,), dtype=dtype, device=gen.device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(layers: list[dict], x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    """Dense layers with SiLU between them, and after the last where
    ``final_act``."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = F.silu(x)
    return x


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``np.asarray`` gives them from
    a JAX array) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(a.copy(), device=device)


def tree_from_numpy(tree, device):
    """Every array of a nested dict / list tree as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {key: tree_from_numpy(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(val, device) for val in tree]
    return tensor_from_numpy(tree, device)
