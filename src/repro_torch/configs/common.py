"""Shape sets of the architectures, as plain sizes: the port of the GNN part
of ``repro/configs/common.py`` (``GNN_SHAPE_META`` and the sizes of
``gnn_shapes()``).

The JAX package describes each (arch, shape) cell by ``jax.ShapeDtypeStruct``
stand-ins for its multi-pod dry run; here a cell is its node, edge and graph
counts, and ``GraphShape.specs()`` gives each input's shape and torch dtype.
The LM and recsys shape sets have no port yet; they belong in this module.
"""
from __future__ import annotations

import dataclasses

import torch


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

    @property
    def n_nodes(self) -> int:
        return pad512(self.n_true)

    @property
    def n_edges(self) -> int:
        return pad512(self.e_true)

    def specs(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Every input of the cell's batch: name -> (shape, dtype)."""
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
