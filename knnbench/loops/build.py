"""Index builds for fresh object sets: each operation is
``construct.build_knn_tables(bn, objects, k, plans=plans)``, the sweep
schedules prepared once in set-up, over a pool of object sets drawn from the
seed and cycled."""
from __future__ import annotations

import torch

from knnbench import generator
from knnbench.yardstick import least_seconds, sweep_work


class Loop:
    def __init__(self, cell, bn, n: int, seed: int, dev: torch.device):
        from repro_torch.core import construct

        cfg, mix = cell.cfg, cell.mix
        self.k, self.bn, self.dev = int(cfg["k"]), bn, dev
        rng = generator.stream(seed, "objects")
        self.pool = int(mix["pool"])
        self.objects = [generator.object_set(n, float(cfg["mu"]), rng) for _ in range(self.pool)]
        self.plans = None
        if bn is not None:
            self.plans = (construct.prepare_sweep(bn, "up", device=dev),
                          construct.prepare_sweep(bn, "down", device=dev))
        self.sample_size = int(mix["check"]["builds"])
        self.dijkstra = int(mix["check"]["dijkstra"])

    def op(self, i: int):
        from repro_torch.core import construct

        j = i % self.pool
        return j, construct.build_knn_tables(self.bn, self.objects[j], self.k, device=self.dev,
                                             plans=self.plans), 1

    def warm(self, dev) -> None:
        self.op(0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def least_s(self, n: int, pools: set[int]) -> dict[int, float]:
        # both sweeps: every real neighbour slot of BNS^< and BNS^>, n rows each
        slots = int((self.bn.lo_ids >= 0).sum()) + int((self.bn.hi_ids >= 0).sum())
        nbytes, nops = sweep_work(slots, 2 * n, self.k)
        return {j: least_seconds(nbytes, nops) for j in pools}

    def judge(self, bell, dij, sample, rng) -> dict:
        from knnbench.reference.judge import judge_build

        self.plans = None
        builds = [(self.objects[j], ids, d) for j, (ids, d) in sample]
        picks = [(int(rng.integers(0, len(builds))), int(rng.integers(0, bell.n)))
                 for _ in range(self.dijkstra)] if builds else []
        return judge_build(bell, dij, builds, picks)

    def control(self, bell, dij, rng, bits: int):
        from knnbench.reference.bellman import lowered

        sample, rounds, fixed = [], [], []
        for j in range(self.sample_size):
            exact_ids, exact_d, r = bell.fixed_point(self.objects[j], self.k)
            sample.append((j, lowered(exact_ids, exact_d, bits)))
            rounds.append(r)
            fixed = [(self.objects[j], exact_ids, exact_d)]
        return dict(self.judge(bell, dij, sample, rng), rounds=rounds), fixed
