"""nequip [arXiv:2101.03164]. 5 layers, 32 channels, l_max=2, 8 RBFs,
cutoff 5, O(3)-equivariant tensor products."""
from repro_torch.configs.common import GNN_SHAPE_META
from repro_torch.models.gnn.nequip import NequIPConfig


def make_config(shape: str = "molecule") -> NequIPConfig:
    meta = GNN_SHAPE_META[shape]
    return NequIPConfig(
        name="nequip",
        n_layers=5,
        d_hidden=32,
        l_max=2,
        n_rbf=8,
        cutoff=5.0,
        d_feat=meta["d_feat"],
        n_out=1 if meta["task"] == "energy" else meta["n_classes"],
        task=meta["task"],
    )


def make_smoke() -> NequIPConfig:
    return NequIPConfig(
        name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2, n_rbf=4, n_species=4
    )
