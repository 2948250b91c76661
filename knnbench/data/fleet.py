"""The benchmark's moving fleet: a replayable trace of vehicle moves.

A frozen copy of the rules of the port's ``workloads/fleet.FleetSim``: each
vehicle holds one vertex (two never share one) and drives a shortest path to
a uniformly drawn destination, one street a step; each tick the vehicles
step in a random order; a vehicle whose next vertex is occupied waits, and
after 2 blocked steps in a row it re-plans to a fresh destination; on
arrival it draws a fresh destination. To keep a grid-384 fleet cheap to
generate, every trip a step needs is planned at the step's start, in
batches of ``scipy.sparse.csgraph.dijkstra`` calls with predecessors
(FleetSim plans each trip with a Python heap, which at grid 384 takes
longer than the whole trace): a vehicle
draws its fresh destination at the start of the step after its arrival or
its second blocked step, before any vehicle moves, where FleetSim draws it
at the vehicle's turn in that step. It moves in that step either way. Among
paths of equal length, scipy's predecessors choose.

The trace is a function of the network and of the ``fleet`` parameters of
a configuration (``trace_seed`` seeds it, as ``seed`` seeds the network), so
it is built once and kept under the benchmark's cache, keyed by those
parameters and by this file's source. A tick's moves are in execution order,
so staging them in order through ``QueryEngine.stage_move`` is always valid;
the moves of a tick in reverse order, each ``(u, v)`` as ``(v, u)``, undo it
and are valid too.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

_SOURCES = ("fleet.py", "road.py")
_CHUNK = 64                       # sources a dijkstra call
_BLOCKED_REPLAN = 2               # blocked steps in a row before a re-plan


@dataclasses.dataclass(frozen=True)
class Trace:
    """``start``: (vehicles,) int32 initial vertices, vehicle order;
    ``moves``: (m, 2) int32 (u, v) of every tick in order; ``bounds``:
    (ticks + 1,) int64, tick t's moves are ``moves[bounds[t]:bounds[t+1]]``."""

    start: np.ndarray
    moves: np.ndarray
    bounds: np.ndarray

    @property
    def ticks(self) -> int:
        return len(self.bounds) - 1

    def tick(self, t: int) -> np.ndarray:
        return self.moves[self.bounds[t]:self.bounds[t + 1]]

    def states(self) -> list[np.ndarray]:
        """The sorted object set before tick 0 and after each tick."""
        occupied = set(self.start.tolist())
        out = [np.sort(self.start)]
        for t in range(self.ticks):
            for u, v in self.tick(t).tolist():
                occupied.remove(u)
                occupied.add(v)
            out.append(np.array(sorted(occupied), np.int32))
        return out


def params(cfg: dict) -> dict:
    """What the trace is a function of: the network's parameters and the fleet's."""
    net = dict(cfg["network"])
    net.pop("generator", None)
    fleet = {key: cfg["fleet"][key] for key in ("vehicles", "steps_per_tick", "trace_seed",
                                                "trace_ticks")}
    return {"network": net, "fleet": fleet}


def cache_path(cache_dir: Path, cfg: dict) -> Path:
    h = hashlib.sha256(json.dumps(params(cfg), sort_keys=True).encode())
    here = Path(__file__).resolve().parent
    for name in _SOURCES:
        h.update((here / name).read_bytes())
    return Path(cache_dir) / f"fleet-{h.hexdigest()[:24]}.npz"


def load_or_build(cfg: dict, cache_dir: Path, network=None, log=None) -> Trace:
    """The configuration's trace, read from ``cache_dir`` or generated and
    kept there (``network``: the road network, when the caller has it)."""
    path = cache_path(cache_dir, cfg)
    if path.exists():
        try:
            with np.load(path) as z:
                return Trace(z["start"], z["moves"], z["bounds"])
        except (OSError, ValueError, KeyError):  # a damaged file: build anew
            pass
    if network is None:
        from knnbench.data import road

        network = road.road_network(**params(cfg)["network"])
    fleet = cfg["fleet"]
    t0 = time.perf_counter()
    trace = generate(network.indptr, network.indices, network.weights,
                     vehicles=int(fleet["vehicles"]), steps_per_tick=int(fleet["steps_per_tick"]),
                     seed=int(fleet["trace_seed"]), ticks=int(fleet["trace_ticks"]))
    if log is not None:
        log({"fleet_trace_built_s": time.perf_counter() - t0, "cache": path.name})
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(f"{path.name}.{os.getpid()}.part")
    with open(part, "wb") as f:
        np.savez(f, start=trace.start, moves=trace.moves, bounds=trace.bounds)
    os.replace(part, path)
    return trace


def generate(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray, *, vehicles: int,
             steps_per_tick: int, seed: int, ticks: int) -> Trace:
    """The fleet's first ``ticks`` ticks on the CSR network (both directions)."""
    n = len(indptr) - 1
    if not 0 < vehicles < n:
        raise ValueError(f"vehicles must be in (0, {n}), got {vehicles}")
    graph = csr_matrix((weights, indices, indptr), shape=(n, n))
    rng = np.random.default_rng(seed)
    pos = rng.choice(n, size=vehicles, replace=False).astype(np.int64)
    start = pos.astype(np.int32)
    occupied = set(pos.tolist())
    routes: list[list[int]] = [[] for _ in range(vehicles)]  # vertices ahead, next last
    blocked = [0] * vehicles
    replan: set[int] = set()
    moves: list[tuple[int, int]] = []
    bounds = [0]
    for _ in range(ticks):
        for _ in range(steps_per_tick):
            need = sorted(replan | {i for i in range(vehicles) if not routes[i]})
            replan.clear()
            _plan(graph, n, rng, pos, routes, need)
            for i in rng.permutation(vehicles).tolist():
                if not routes[i]:        # no destination off its vertex: stays
                    continue
                nxt = routes[i][-1]
                if nxt in occupied:
                    blocked[i] += 1
                    if blocked[i] >= _BLOCKED_REPLAN:
                        replan.add(i)
                        blocked[i] = 0
                    continue
                blocked[i] = 0
                cur = int(pos[i])
                occupied.discard(cur)
                occupied.add(nxt)
                pos[i] = nxt
                routes[i].pop()
                moves.append((cur, nxt))
        bounds.append(len(moves))
    return Trace(start, np.asarray(moves, np.int32).reshape(-1, 2), np.asarray(bounds, np.int64))


def _plan(graph, n: int, rng: np.random.Generator, pos: np.ndarray, routes: list, need: list
          ) -> None:
    """A fresh uniform destination for each vehicle in ``need`` (vehicle
    order) and its shortest path, sources in batches of ``_CHUNK``."""
    if not need:
        return
    dst = {}
    for i in need:
        for _ in range(64):
            d = int(rng.integers(0, n))
            if d != pos[i]:
                break
        dst[i] = d
    for lo in range(0, len(need), _CHUNK):
        chunk = need[lo:lo + _CHUNK]
        _, pred = dijkstra(graph, indices=pos[chunk], return_predecessors=True)
        for row, i in enumerate(chunk):
            path, v, src = [], dst[i], int(pos[i])
            while v != src:  # the route, destination first: the next vertex pops off the end
                path.append(v)
                v = int(pred[row, v])
                if v < 0:
                    raise ValueError(f"no path from {src} to {dst[i]}")
            routes[i] = path
