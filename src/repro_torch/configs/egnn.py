"""egnn [arXiv:2102.09844]. 4 layers, d_hidden=64, E(n)-equivariant."""
from repro_torch.configs.common import GNN_SHAPE_META
from repro_torch.models.gnn.egnn import EGNNConfig


def make_config(shape: str = "molecule") -> EGNNConfig:
    meta = GNN_SHAPE_META[shape]
    return EGNNConfig(
        name="egnn",
        n_layers=4,
        d_hidden=64,
        d_feat=meta["d_feat"],
        n_out=1 if meta["task"] == "energy" else meta["n_classes"],
        task=meta["task"],
    )


def make_smoke() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_feat=8, n_out=1)
