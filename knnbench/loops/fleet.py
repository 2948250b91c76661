"""A moving fleet: each operation is one tick of the configuration's fleet
trace (``data/fleet.py``) against an index built in set-up from the
trace's first positions, every answer fresh:

1. the tick's moves, staged in order with ``QueryEngine.stage_move``;
2. ``QueryEngine.flush_updates()``, which publishes them;
3. ``QueryEngine.query_batch(us, k)`` at the configuration's k, over a
   pool of batches drawn from the seed and cycled.

The trace's ticks are replayed forward, then backward (a tick's moves in
reverse order, each ``(u, v)`` as ``(v, u)``), and so on, so the fleet
keeps moving however long the window. The harness restarts its operation
count after set-up and after the profiler's first start, while the fleet's
state only moves forward, so the loop keeps its own cursor. An operation's
pool index is the cursor modulo twice the trace's ticks: it names the
object set after the tick, which the judge rebuilds.
"""
from __future__ import annotations

import json

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from knnbench import flushcost, generator, spans, spec
from knnbench.data import fleet


class Loop:
    def __init__(self, cell, bn, n: int, seed: int, dev: torch.device):
        cfg, mix = cell.cfg, cell.mix
        self.k = int(cfg["k"])
        trace = fleet.load_or_build(cfg, spec.CACHE,
                                    log=lambda obj: print(json.dumps(obj), flush=True))
        self.ticks = [trace.tick(t) for t in range(trace.ticks)]
        self.states = trace.states()
        self.cycle = 2 * len(self.ticks)
        self.cursor = 0
        self.engine = None
        if bn is not None:
            from repro_torch.core.engine import QueryEngine

            self.engine = QueryEngine.build(bn, self.states[0], self.k, device=dev)
        shape = (int(mix["pool"]), int(mix["batch"]))
        self.us = generator.vertices(n, shape, generator.stream(seed, "vertices"),
                                     mix.get("vertices"))
        self.sample_size = int(mix["check"]["ticks"])
        self.dijkstra = int(mix["check"]["dijkstra"])
        self.k3_bytes: dict[int, int] = {}

    def moves(self, q: int) -> np.ndarray:
        """The (u, v) moves of phase ``q`` of the cycle, in staging order."""
        if q < len(self.ticks):
            return self.ticks[q]
        return self.ticks[self.cycle - 1 - q][::-1, ::-1]

    def state(self, q: int) -> np.ndarray:
        """The object set after phase ``q`` of the cycle."""
        return self.states[q + 1 if q < len(self.ticks) else self.cycle - 1 - q]

    def batch(self, q: int) -> np.ndarray:
        return self.us[q % self.us.shape[0]]

    def op(self, i: int):
        q = self.cursor % self.cycle
        self.cursor += 1
        eng = self.engine
        for u, v in self.moves(q).tolist():
            eng.stage_move(u, v)
        eng.flush_updates()
        if _profiler._is_profiler_enabled:  # a traced tick: its K3 work, for the roofline
            self.k3_bytes[q] = spans.last_count(flushcost.FLUSH, "k3_bytes")
        us = self.batch(q)
        return q, eng.query_batch(us, self.k), len(us)

    def warm(self, dev) -> None:
        for i in range(2):
            self.op(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def least_s(self, n: int, pools: set[int]) -> dict[int, float]:
        return {q: flushcost.least_s(self.k3_bytes[q]) for q in pools
                if self.k3_bytes.get(q) is not None}

    def judge(self, bell, dij, sample, rng, final=None) -> dict:
        """``final``: the published table, when not the engine's (the control)."""
        from knnbench.reference.fleet import judge_fleet

        ticks = []
        for q, out in sample:  # the control's outputs carry the exact table too
            ids, d, exact = (*out, None)[:3]
            ticks.append((self.state(q), self.batch(q), ids, d, exact))
        picks = [(int(rng.integers(0, len(ticks))), int(rng.integers(0, self.us.shape[1])))
                 for _ in range(self.dijkstra)] if ticks else []
        if final is None:
            q = (self.cursor - 1) % self.cycle
            final = (self.state(q), *self.engine.tables)
        self.engine = None
        return judge_fleet(bell, dij, self.k, ticks, final, picks)

    def control(self, bell, dij, rng, bits: int):
        from knnbench.reference.bellman import lowered

        sample, rounds, fixed = [], [], []
        for q in range(self.sample_size):
            objects = self.state(q)
            exact_ids, exact_d, r = bell.fixed_point(objects, self.k)
            ids, d = lowered(exact_ids, exact_d, bits)
            u = torch.from_numpy(self.batch(q).astype(np.int64)).to(bell.device)
            sample.append((q, (ids[u], d[u], (exact_ids, exact_d))))
            rounds.append(r)
            fixed = [(objects, exact_ids, exact_d)]
        final = (fixed[0][0], ids, d)
        numbers = self.judge(bell, dij, sample, rng, final=final)
        return dict(numbers, rounds=rounds), fixed
