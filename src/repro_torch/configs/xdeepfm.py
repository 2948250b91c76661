"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim 10, CIN 200-200-200,
MLP 400-400, 10^6 rows per field table (1.56 GB of float32 tables), bags of 3
ids in the first 4 fields.

The cells this configuration serves, from the JAX package's
``recsys_shapes`` (``repro/configs/common.py``), as plain sizes.
"""
from repro_torch.models.recsys import XDeepFMConfig

_BAG = 3

SERVE_P99_BATCH = 512          # serve_p99: forward on 512 rows
SERVE_BULK_BATCH = 262_144     # serve_bulk: forward on 262,144 rows
RETRIEVAL_CANDIDATES = 1_000_000  # retrieval_cand: one query against 10^6 items
RETRIEVAL_K = 100


def make_config() -> XDeepFMConfig:
    return XDeepFMConfig(
        name="xdeepfm",
        n_sparse=39,
        embed_dim=10,
        table_rows=1_000_000,
        cin_layers=(200, 200, 200),
        mlp_layers=(400, 400),
        multi_hot_fields=4,
        bag_size=_BAG,
    )


def make_smoke() -> XDeepFMConfig:
    return XDeepFMConfig(
        name="xdeepfm-smoke",
        n_sparse=6,
        embed_dim=4,
        table_rows=64,
        cin_layers=(8, 8),
        mlp_layers=(16,),
        bag_size=_BAG,
    )
