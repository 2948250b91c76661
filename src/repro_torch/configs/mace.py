"""mace [arXiv:2206.07697]. 2 layers, 128 channels, l_max=2, correlation
order 3, 8 RBFs, E(3)-ACE higher-order message passing."""
from repro_torch.configs.common import GNN_SHAPE_META
from repro_torch.models.gnn.mace import MACEConfig


def make_config(shape: str = "molecule") -> MACEConfig:
    meta = GNN_SHAPE_META[shape]
    return MACEConfig(
        name="mace",
        n_layers=2,
        d_hidden=128,
        l_max=2,
        correlation_order=3,
        n_rbf=8,
        cutoff=5.0,
        d_feat=meta["d_feat"],
        n_out=1 if meta["task"] == "energy" else meta["n_classes"],
        task=meta["task"],
    )


def make_smoke() -> MACEConfig:
    return MACEConfig(
        name="mace-smoke", n_layers=2, d_hidden=8, l_max=2, correlation_order=3,
        n_rbf=4, n_species=4
    )
