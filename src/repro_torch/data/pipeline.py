"""Deterministic synthetic batches (numpy only), the port's copies of the JAX
package's ``LMStream``, ``MarkovLMStream``, ``RecsysStream``, ``GraphStream``
and ``FullGraphStream`` (``repro/data/pipeline.py``).

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


@dataclasses.dataclass(frozen=True)
class GraphStream:
    """Batched small graphs (the `molecule` regime) with positions/species."""

    n_nodes: int
    n_edges: int
    batch: int
    n_species: int = 16
    d_feat: int = 0
    n_classes: int = 4
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        n, e, b = self.n_nodes, self.n_edges, self.batch
        src = rng.integers(0, n, size=(b, e // 2))
        dst = rng.integers(0, n, size=(b, e // 2))
        offs = (np.arange(b) * n)[:, None]
        s = np.concatenate([(src + offs).ravel(), (dst + offs).ravel()])
        d = np.concatenate([(dst + offs).ravel(), (src + offs).ravel()])
        batch = {
            "edge_index": np.stack([s, d]).astype(np.int32),
            "pos": rng.standard_normal((b * n, 3)).astype(np.float32) * 2.0,
            "graph_id": np.repeat(np.arange(b), n).astype(np.int32),
            "graph_targets": rng.standard_normal(b).astype(np.float32),
            "labels": rng.integers(0, self.n_classes, size=b * n).astype(np.int32),
        }
        if self.d_feat:
            batch["node_feat"] = rng.standard_normal((b * n, self.d_feat)).astype(np.float32)
        else:
            batch["species"] = rng.integers(0, self.n_species, size=b * n).astype(np.int32)
        return batch


@dataclasses.dataclass(frozen=True)
class FullGraphStream:
    """Fixed full-batch citation-style graph with synthetic labels."""

    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed)  # fixed graph, step-independent
        src = rng.integers(0, self.n_nodes, size=self.n_edges // 2)
        dst = rng.integers(0, self.n_nodes, size=self.n_edges // 2)
        return {
            "edge_index": np.stack(
                [np.concatenate([src, dst]), np.concatenate([dst, src])]
            ).astype(np.int32),
            "node_feat": rng.standard_normal((self.n_nodes, self.d_feat)).astype(np.float32),
            "pos": rng.standard_normal((self.n_nodes, 3)).astype(np.float32),
            "labels": rng.integers(0, self.n_classes, size=self.n_nodes).astype(np.int32),
        }
