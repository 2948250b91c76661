"""The BN-Graph of a benchmark network, built once by the port and kept.

A service computes a network's BN-Graph once, offline; no timed window
holds it. The first run of a cell in a checkout builds it with the port's
``build_bngraph`` and saves its fields as ``dataclasses.asdict`` gives them
(so a program change to the fields needs no change here), compressed:
nearly all of the padded tables is padding. Later runs load them and hand
them to the port's ``bngraph_from_arrays``. The key is the network's
generator parameters and the port's sources that make the graph, so a change
to any of them builds anew.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from pathlib import Path

import numpy as np

PORT_SOURCES = ("repro_torch/core/bngraph.py", "repro_torch/graph/csr.py",
                "repro_torch/graph/generators.py")


def cache_path(cache_dir: Path, src: Path, network: dict) -> Path:
    h = hashlib.sha256(json.dumps(network, sort_keys=True).encode())
    for rel in PORT_SOURCES:
        h.update((src / rel).read_bytes())
    return cache_dir / f"bngraph-{h.hexdigest()[:24]}.npz"


class Loader:
    """Reads a cached BN-Graph's fields on a thread, beside the rest of set-up."""

    def __init__(self, path: Path):
        self.path = path
        self.fields: dict | None = None
        self._thread = threading.Thread(target=self._load, daemon=True)
        if path.exists():
            self._thread.start()

    def _load(self) -> None:
        try:
            with np.load(self.path) as z:
                self.fields = {name: z[name] for name in z.files}
        except (OSError, ValueError, KeyError):  # a damaged file: build anew
            self.fields = None

    def result(self) -> dict | None:
        if self._thread.ident is not None:  # started
            self._thread.join()
        return self.fields


def bngraph(loader: Loader, network, log) -> tuple[object, float | None]:
    """The port's BNGraph of ``network``: loaded, or built and saved.
    Returns it and the seconds the build took (None when loaded)."""
    from repro_torch.core.bngraph import bngraph_from_arrays

    fields = loader.result()
    if fields is not None:
        return bngraph_from_arrays(**fields), None
    from repro_torch.core.bngraph import build_bngraph
    from repro_torch.graph.csr import from_edges

    t0 = time.perf_counter()
    bn = build_bngraph(from_edges(network.n, network.edges()))
    seconds = time.perf_counter() - t0
    log({"bngraph_built_s": seconds, "cache": str(loader.path.name)})
    path = loader.path
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(f"{path.name}.{os.getpid()}.part")
    with open(part, "wb") as f:
        np.savez_compressed(f, **dataclasses.asdict(bn))
    os.replace(part, path)
    return bn, seconds
