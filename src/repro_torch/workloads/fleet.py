"""Moving-fleet simulator: vehicles driving shortest-path trips on the network.

Each vehicle occupies one vertex (the engine's candidate objects ARE vertices,
so two vehicles never share one — a blocked vehicle waits, which is also what
real congestion looks like). A vehicle drives the shortest path to a randomly
drawn destination, one street per tick by default, and draws a fresh trip on
arrival. ``tick()`` returns the batch of ``(src, dst)`` moves executed that
tick, in an order that is always valid to stage sequentially into
``QueryEngine.stage_move`` (a vertex freed earlier in the tick may be entered
later in the same tick, never the reverse).

This is the JAX package's simulator, copied: the same seed and
``steps_per_tick`` give the same positions and the same moves, tick for tick.

The simulator is deliberately host-side and deterministic (seeded), so a
replayed movement trace through different update strategies (fused moves, or
split delete + insert flushes) measures the engine, not the traffic.
"""
from __future__ import annotations

import heapq
import time

import numpy as np

from repro_torch.device import synchronize
from repro_torch.graph.csr import Graph


def shortest_path(g: Graph, src: int, dst: int) -> list[int]:
    """Dijkstra path src -> dst as a vertex list (inclusive of both ends)."""
    if src == dst:
        return [src]
    dist = np.full(g.n, np.inf)
    dist[src] = 0.0
    parent = np.full(g.n, -1, np.int64)
    heap: list[tuple[float, int]] = [(0.0, src)]
    while heap:
        d, v = heapq.heappop(heap)
        if v == dst:
            break
        if d > dist[v]:
            continue
        nbrs, ws = g.neighbors(v)
        for nb, w in zip(nbrs.tolist(), ws.tolist()):
            nd = d + w
            if nd < dist[nb]:
                dist[nb] = nd
                parent[nb] = v
                heapq.heappush(heap, (nd, nb))
    if not np.isfinite(dist[dst]):
        raise ValueError(f"no path from {src} to {dst}")
    path = [dst]
    while path[-1] != src:
        path.append(int(parent[path[-1]]))
    path.reverse()
    return path


class FleetSim:
    """A fleet of vehicles on shortest-path trips over a road network.

    Parameters
    ----------
    g:           the road network (vertices = intersections).
    fleet_size:  number of vehicles; must leave room to maneuver
                 (``fleet_size < g.n``).
    seed:        RNG seed for initial positions and trip destinations.
    steps_per_tick: streets each vehicle advances per tick (the tick rate
                 knob: 1 simulates dense ticks, larger values sparser ones).
    """

    def __init__(self, g: Graph, *, fleet_size: int, seed: int = 0, steps_per_tick: int = 1):
        if not 0 < fleet_size < g.n:
            raise ValueError(f"fleet_size must be in (0, {g.n}), got {fleet_size}")
        if steps_per_tick < 1:
            raise ValueError("steps_per_tick must be >= 1")
        self.g = g
        self.steps_per_tick = int(steps_per_tick)
        self._rng = np.random.default_rng(seed)
        self._pos = [int(v) for v in self._rng.choice(g.n, size=fleet_size, replace=False)]
        self._occupied = set(self._pos)
        # _route[i]: vertices still ahead of vehicle i (current vertex excluded)
        self._routes: list[list[int]] = [[] for _ in range(fleet_size)]
        self._blocked_streak = [0] * fleet_size
        self.ticks = 0
        self.trips_completed = 0
        self.moves_total = 0
        self.blocked_total = 0
        self.reroutes = 0

    @property
    def fleet_size(self) -> int:
        return len(self._pos)

    @property
    def positions(self) -> np.ndarray:
        """Current vehicle vertices, sorted — the engine's object set M."""
        return np.sort(np.asarray(self._pos, dtype=np.int32))

    def _assign_trip(self, i: int) -> None:
        """Draw a fresh destination for vehicle i and route it."""
        src = self._pos[i]
        for _ in range(64):
            dst = int(self._rng.integers(0, self.g.n))
            if dst != src:
                break
        # reversed so the remaining route pops from the tail in O(1)
        self._routes[i] = shortest_path(self.g, src, dst)[1:][::-1]

    def tick(self) -> list[tuple[int, int]]:
        """Advance the fleet one tick; returns the executed (src, dst) moves.

        Vehicles move in a random order each tick (fairness under
        contention); a vehicle whose next vertex is occupied waits. The
        returned moves are in execution order, so staging them sequentially
        through ``QueryEngine.stage_move`` is always valid.
        """
        moves: list[tuple[int, int]] = []
        self.ticks += 1
        for _ in range(self.steps_per_tick):
            for i in self._rng.permutation(self.fleet_size):
                i = int(i)
                if not self._routes[i]:
                    self._assign_trip(i)
                nxt = self._routes[i][-1]
                if nxt in self._occupied:
                    # Blocked. Two vehicles heading into each other would
                    # otherwise deadlock forever (both next-vertices stay
                    # occupied), so after two blocked steps the vehicle gives
                    # up on this trip and routes somewhere else — a detour.
                    self.blocked_total += 1
                    self._blocked_streak[i] += 1
                    if self._blocked_streak[i] >= 2:
                        self._assign_trip(i)
                        self.reroutes += 1
                        self._blocked_streak[i] = 0
                    continue
                self._blocked_streak[i] = 0
                cur = self._pos[i]
                self._occupied.discard(cur)
                self._occupied.add(nxt)
                self._pos[i] = nxt
                self._routes[i].pop()
                if not self._routes[i]:
                    self.trips_completed += 1
                moves.append((cur, nxt))
        self.moves_total += len(moves)
        return moves

    def stats(self) -> dict:
        return {
            "fleet_size": self.fleet_size,
            "ticks": self.ticks,
            "moves_total": self.moves_total,
            "trips_completed": self.trips_completed,
            "blocked_total": self.blocked_total,
            "reroutes": self.reroutes,
        }


def drive_fleet_ticks(engine, tick_moves, *, batch: int, rng, split: bool = False) -> dict:
    """The moving-fleet serving loop of ``launch/serve.py``: for every tick's
    move batch, stage the movement (fused ``stage_move``, or with
    ``split=True``, the baseline, a delete flush followed by staged inserts),
    serve one timed query batch, then flush. ``tick_moves`` is any iterable
    of (src, dst) move lists: live ``FleetSim.tick()`` calls or a
    pre-generated trace being replayed. The loop is engine-agnostic: the
    scalar ``QueryEngine`` and the ``ShardedQueryEngine`` are driven alike.

    The query latency is taken to the end of the batch on the engine's
    device (a synchronize, not just the enqueue).

    Returns ``{"wall_s", "ticks", "moves", "lat"}`` with ``lat`` the
    per-tick query-batch latencies in seconds (percentile material).
    """
    lat: list[float] = []
    ticks = moves_done = 0
    t0 = time.perf_counter()
    for moves in tick_moves:
        if split:
            for u, _ in moves:
                engine.stage_delete(u)
            engine.flush_updates()
            for _, v in moves:
                engine.stage_insert(v)
        else:
            for u, v in moves:
                engine.stage_move(u, v)
        t1 = time.perf_counter()
        engine.query_batch(rng.integers(0, engine.n, size=batch))
        synchronize(engine.device)
        lat.append(time.perf_counter() - t1)
        engine.flush_updates()
        ticks += 1
        moves_done += len(moves)
    return {
        "wall_s": time.perf_counter() - t0,
        "ticks": ticks,
        "moves": moves_done,
        "lat": lat,
    }
