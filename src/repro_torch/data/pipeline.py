"""Deterministic synthetic batches (numpy only), the port's copies of the JAX
package's ``LMStream``, ``MarkovLMStream`` and ``RecsysStream``
(``repro/data/pipeline.py``).

``batch_at(step)`` is a pure function of (seed, step), and gives the same
arrays as the JAX package's stream with the same fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1), dtype=np.int64)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass(frozen=True)
class MarkovLMStream:
    """First-order Markov token stream: learnable signal for the training
    examples (the loss falls toward the chain's entropy, log(branching))."""

    vocab: int
    batch: int
    seq: int
    branching: int = 4  # successors per token; entropy = log(branching)
    seed: int = 0

    def _table(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab, size=(self.vocab, self.branching))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        table = self._table()
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        choices = rng.integers(0, self.branching, size=(self.batch, self.seq))
        for t in range(self.seq):
            toks[:, t + 1] = table[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass(frozen=True)
class RecsysStream:
    n_sparse: int
    bag: int
    rows: int
    batch: int
    multi_hot_fields: int = 4
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        ids = rng.integers(0, self.rows, size=(self.batch, self.n_sparse, self.bag))
        # single-hot fields: only slot 0 valid
        ids[:, self.multi_hot_fields:, 1:] = -1
        labels = rng.integers(0, 2, size=(self.batch,))
        return {"sparse_ids": ids.astype(np.int32), "labels": labels.astype(np.int32)}
