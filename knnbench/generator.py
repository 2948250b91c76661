"""The one traffic generator: draws a mix's inputs from the seed.

Each kind of draw is keyed by a stream name, so one draw never shifts
another's numbers, and every seed draws the same sizes: only the vertices
and the object sets move with the seed. A mix file chooses a distribution
by name and its parameters (``vertices``), so a new mix over them is data.
"""
from __future__ import annotations

import zlib

import numpy as np


def stream(seed: int, name: str) -> np.random.Generator:
    """An independent generator for one kind of draw of one seed (any
    non-negative whole number, 64 bits and more)."""
    return np.random.default_rng([int(seed), zlib.crc32(name.encode())])


def object_set(n: int, mu: float, rng: np.random.Generator) -> np.ndarray:
    """Candidate objects at density mu = |M| / |V|, sorted int32 (as the
    port's ``pick_objects`` draws them)."""
    size = max(1, int(round(mu * n)))
    return np.sort(rng.choice(n, size=size, replace=False)).astype(np.int32)


def vertices(n: int, shape: tuple[int, ...], rng: np.random.Generator,
             dist: dict | None = None) -> np.ndarray:
    """Query vertices. ``dist`` (a mix's ``vertices``): ``{"dist":
    "uniform"}`` (the default) over [0, n); ``{"dist": "zipf", "s": s}``
    gives the vertex of rank r, in an order of [0, n) drawn from the same
    stream, with probability proportional to r^-s."""
    dist = dist or {"dist": "uniform"}
    if dist["dist"] == "uniform":
        return rng.integers(0, n, size=shape, dtype=np.int32)
    if dist["dist"] == "zipf":
        order = rng.permutation(n).astype(np.int32)
        p = np.arange(1, n + 1, dtype=np.float64) ** -float(dist["s"])
        return order[rng.choice(n, size=shape, p=p / p.sum())]
    raise ValueError(f"unknown vertex distribution {dist['dist']!r}")
