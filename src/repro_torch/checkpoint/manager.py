"""Checkpoints with an atomic commit: the port's own copy of
``repro/checkpoint/manager.py`` (``save`` / ``latest_step`` / ``restore`` /
``prune``), on the same disk layout, so a directory written by either package
restores in the other:

    <dir>/step_<N>/             N as eight digits
        manifest.json           step, tree description, every leaf's shape and dtype
        shard_0.npz             the leaves, keyed by their key paths joined by \\x1f

Key paths follow JAX's pytree order (dict keys sorted, sequence indices), and
a bfloat16 leaf is stored as its uint16 bit pattern with dtype "bfloat16" in
the manifest. A save writes ``step_<N>.tmp``, fsyncs the manifest and renames
the directory, so a crash mid-save never leaves a half-written checkpoint
where ``latest_step`` looks. One host, one shard: the JAX package's
re-placement under a sharding on restore has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths

_SEP = "\x1f"  # key-path separator inside npz archives


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _savable(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor or array) as the array to store and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _describe(tree) -> str:
    """The tree's structure, leaves as '*' (the JAX package writes its treedef
    here; neither package reads it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{key}': {_describe(tree[key])}" for key in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(sub) for sub in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save(ckpt_dir: str | Path, step: int, tree: Any, *, host_id: int = 0) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        key = _key(path)
        flat[key], dtypes[key] = _savable(leaf)
    np.savez(tmp / f"shard_{host_id}.npz", **flat)
    manifest = {
        "step": step,
        "treedef": _describe(tree),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in flat.items()},
        "hosts": 1,
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if (p.name.startswith("step_") and not p.name.endswith(".tmp")
                and (p / "manifest.json").exists()):
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, like: Any, *, step: int | None = None,
            locate: Callable[[tuple], tuple[tuple, int | None]] | None = None
            ) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf a
    new tensor with the dtype and on the device of ``like``'s leaf at its key
    path. Returns (tree, step); the newest complete step unless ``step``.

    ``locate(path) -> (stored_path, row)`` reads ``like``'s leaf at ``path``
    from another key path of the checkpoint, and from its row ``row`` where
    that is not None: a tree with its layers in a list restores from a
    checkpoint that stacks them, without a stacked template."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    with np.load(d / "shard_0.npz") as npz:
        data = dict(npz)
    with open(d / "manifest.json") as f:
        manifest = json.load(f)

    def load(path: tuple, leaf: torch.Tensor) -> torch.Tensor:
        stored, row = locate(path) if locate else (path, None)
        key = _key(stored)
        arr = data[key] if row is None else data[key][row]
        if manifest["leaves"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device=leaf.device, dtype=leaf.dtype)

    by_path = {path: load(path, leaf) for path, leaf in leaves_with_paths(like)}
    return _rebuild(like, by_path), step


def _rebuild(tree, by_path: dict, prefix: tuple = ()):
    """``tree``'s structure with the leaf at each key path from ``by_path``."""
    if isinstance(tree, dict):
        return {key: _rebuild(sub, by_path, prefix + (key,)) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(sub, by_path, prefix + (i,)) for i, sub in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return by_path[prefix]


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    steps = sorted(
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and not p.name.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
