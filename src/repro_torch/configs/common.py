"""Shape sets of the architectures: the port of ``repro/configs/common.py``
(``ShapeCell``, ``lm_shapes``, ``gnn_shapes``, ``GNN_SHAPE_META``,
``recsys_shapes``).

Every (arch, shape) cell is a step kind (``train``, ``prefill``, ``decode``,
``forward``, ``retrieval``, ``knn_build``, ``knn_serve``) and ``specs(cfg)``:
each input's name -> ``(shape, torch dtype)``, or a plain int for a size
that is not an array (``max_len``, ``cache_batch``, ``n_candidates``). The
JAX package gives ``jax.ShapeDtypeStruct`` stand-ins there; the port's dry
run (``launch/dryrun.py``) makes ``meta`` tensors of them. A GNN cell is a
``GraphShape`` (its node, edge and graph counts), which is a cell of kind
``train`` itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar

import torch

Spec = tuple[tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                                     # the step the cell runs
    make_specs: Callable[[Any], dict[str, Any]]   # cfg -> {name: Spec or int}
    skip: str | None = None                       # not None: the cell is skipped, and why

    def specs(self, cfg=None) -> dict[str, Any]:
        return self.make_specs(cfg)


# ---------------------------------------------------------------------------
# LM family (sequence length x global batch); decode and long run decode_step
# ---------------------------------------------------------------------------


def lm_shapes(*, full_attention: bool = True) -> dict[str, ShapeCell]:
    def train_4k(cfg):
        return {"tokens": ((256, 4096), torch.int32), "labels": ((256, 4096), torch.int32)}

    def prefill_32k(cfg):
        return {"tokens": ((32, 32768), torch.int32), "max_len": 32768}

    def decode_32k(cfg):
        return {"tokens": ((128,), torch.int32), "cache_batch": 128, "cache_len": 32768}

    def long_500k(cfg):
        return {"tokens": ((1,), torch.int32), "cache_batch": 1, "cache_len": 524288}

    skip = (
        "pure full-attention arch: 512k-token context requires sub-quadratic "
        "attention (see DESIGN.md long_500k note)" if full_attention else None
    )
    return {
        "train_4k": ShapeCell("train", train_4k),
        "prefill_32k": ShapeCell("prefill", prefill_32k),
        "decode_32k": ShapeCell("decode", decode_32k),
        "long_500k": ShapeCell("decode", long_500k, skip=skip),
    }


# ---------------------------------------------------------------------------
# GNN family: one batch layout for the four archs
# ---------------------------------------------------------------------------


def pad512(x: int) -> int:
    """Round up to a multiple of 512 (the reference pads irregular graph dims
    to a 512-device multiple with dummy-node self-edges)."""
    return ((x + 511) // 512) * 512


@dataclasses.dataclass(frozen=True)
class GraphShape:
    """One GNN cell (a train step's batch): ``n_true`` nodes and ``e_true``
    edges before padding, ``d_feat`` node features (0: species ids),
    ``n_classes`` node classes, ``graphs`` graphs in the batch (0: node
    classification)."""

    n_true: int
    e_true: int
    d_feat: int
    n_classes: int
    graphs: int = 0

    kind: ClassVar[str] = "train"
    skip: ClassVar[str | None] = None

    @property
    def n_nodes(self) -> int:
        return pad512(self.n_true)

    @property
    def n_edges(self) -> int:
        return pad512(self.e_true)

    def specs(self, cfg=None) -> dict[str, Spec]:
        """Every input of the cell's batch: name -> (shape, dtype); the same
        for every GNN config."""
        n, e = self.n_nodes, self.n_edges
        s = {"edge_index": ((2, e), torch.int32), "pos": ((n, 3), torch.float32)}
        if self.d_feat > 0:
            s["node_feat"] = ((n, self.d_feat), torch.float32)
        else:
            s["species"] = ((n,), torch.int32)
        if self.graphs:
            s["graph_id"] = ((n,), torch.int32)
            s["graph_targets"] = ((self.graphs,), torch.float32)
        else:
            s["labels"] = ((n,), torch.int32)
        return s


def gnn_shapes() -> dict[str, GraphShape]:
    # minibatch_lg: sampled subgraph upper bounds for batch_nodes=1024,
    # fanout 15-10: nodes <= 1024*(1+15+150), edges <= 1024*15*(1+10).
    return {
        "full_graph_sm": GraphShape(2708, 10556, 1433, 7),
        "minibatch_lg": GraphShape(169984, 168960, 602, 41),
        "ogb_products": GraphShape(2449029, 61859140, 100, 47),
        "molecule": GraphShape(30 * 128, 64 * 128, 0, 0, graphs=128),
    }


GNN_SHAPE_META = {
    "full_graph_sm": dict(d_feat=1433, n_classes=7, task="node_class"),
    "minibatch_lg": dict(d_feat=602, n_classes=41, task="node_class"),
    "ogb_products": dict(d_feat=100, n_classes=47, task="node_class"),
    "molecule": dict(d_feat=0, n_classes=1, task="energy"),
}


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------


def recsys_shapes(n_sparse: int, bag: int) -> dict[str, ShapeCell]:
    def batch(bsz):
        def specs(cfg):
            return {"sparse_ids": ((bsz, n_sparse, bag), torch.int32),
                    "labels": ((bsz,), torch.int32)}
        return specs

    def retrieval(cfg):
        return {"sparse_ids": ((1, n_sparse, bag), torch.int32), "n_candidates": 1_000_000}

    return {
        "train_batch": ShapeCell("train", batch(65536)),
        "serve_p99": ShapeCell("forward", batch(512)),
        "serve_bulk": ShapeCell("forward", batch(262144)),
        "retrieval_cand": ShapeCell("retrieval", retrieval),
    }
