"""gcn-cora [arXiv:1609.02907]. 2 layers, d_hidden=16, sym-norm aggregation.
Per-shape d_feat/classes follow the assigned shape set."""
from repro_torch.configs.common import GNN_SHAPE_META
from repro_torch.models.gnn.gcn import GCNConfig


def make_config(shape: str = "full_graph_sm") -> GCNConfig:
    meta = GNN_SHAPE_META[shape]
    return GCNConfig(
        name="gcn-cora",
        n_layers=2,
        d_hidden=16,
        d_feat=meta["d_feat"],
        n_classes=meta["n_classes"],
        task=meta["task"],
    )


def make_smoke() -> GCNConfig:
    return GCNConfig(name="gcn-smoke", n_layers=2, d_hidden=8, d_feat=12, n_classes=4)
