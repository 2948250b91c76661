"""Query batches against a serving index built in set-up: each operation is
``QueryEngine.query_batch(us, k)`` at the configuration's k, over a pool of
batches drawn from the seed and cycled."""
from __future__ import annotations

import numpy as np
import torch

from knnbench import generator
from knnbench.yardstick import least_seconds, serve_batch_bytes


class Loop:
    def __init__(self, cell, bn, n: int, seed: int, dev: torch.device):
        cfg, mix = cell.cfg, cell.mix
        self.k, self.dev = int(cfg["k"]), dev
        self.objects = generator.object_set(n, float(cfg["mu"]), generator.stream(seed, "objects"))
        self.engine = None
        if bn is not None:
            from repro_torch.core.engine import QueryEngine

            self.engine = QueryEngine.build(bn, self.objects, self.k, device=dev)
        shape = (int(mix["pool"]), int(mix["batch"]))
        self.us = generator.vertices(n, shape, generator.stream(seed, "vertices"),
                                     mix.get("vertices"))
        self.pool = shape[0]
        self.sample_size = int(mix["check"]["batches"])
        self.dijkstra = int(mix["check"]["dijkstra"])

    def op(self, i: int):
        j = i % self.pool
        return j, self.engine.query_batch(self.us[j], self.k), self.us.shape[1]

    def warm(self, dev) -> None:
        for i in range(min(2, self.pool)):
            self.op(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def least_s(self, n: int, pools: set[int]) -> dict[int, float]:
        return {j: least_seconds(serve_batch_bytes(self.us[j], n, self.k), 0) for j in pools}

    def judge(self, bell, dij, sample, rng, table=None) -> dict:
        """``table``: the served table, when not the engine's (the control)."""
        from knnbench.reference.judge import judge_serve

        batches = [(self.us[j], ids, d) for j, (ids, d) in sample]
        picks = [(int(rng.integers(0, len(batches))), int(rng.integers(0, self.us.shape[1])))
                 for _ in range(self.dijkstra)] if batches else []
        table = tuple(self.engine.tables) if table is None else table
        self.engine = None
        return judge_serve(bell, dij, self.objects, table, batches, picks)

    def control(self, bell, dij, rng, bits: int):
        from knnbench.reference.bellman import lowered

        exact_ids, exact_d, rounds = bell.fixed_point(self.objects, self.k)
        ids, d = lowered(exact_ids, exact_d, bits)
        sample = []
        for j in range(self.sample_size):
            u = torch.from_numpy(self.us[j].astype(np.int64)).to(bell.device)
            sample.append((j, (ids[u], d[u])))
        numbers = self.judge(bell, dij, sample, rng, table=(ids, d))
        return dict(numbers, rounds=rounds), [(self.objects, exact_ids, exact_d)]
