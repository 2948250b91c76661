"""Tiny cells for the CPU tests: the real cells' files, cut in size."""
from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from knnbench import harness


def tiny_cell(name: str, grid: int = 14, k: int = 5, mu: float = 0.05) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.mix = copy.deepcopy(cell.mix)
    cell.cfg["network"].update(nx=grid, ny=grid)
    cell.cfg.update(k=k, mu=mu)
    cell.mix["pool"] = 4
    cell.mix["trace_ops"] = 4
    if cell.mix["loop"] == "serve":
        cell.mix["batch"] = 256
        cell.mix["check"]["dijkstra"] = 24
    return cell


def run_tiny(cell: harness.Cell, cache_dir, seed: int = 2**40 + 3, seconds: float = 0.3,
             trace: bool = False):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                            log=lambda obj: None, cache_dir=Path(cache_dir))
