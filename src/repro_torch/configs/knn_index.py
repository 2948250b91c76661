"""The paper's own configuration: KNN-Index over a USA-scale road network.

  build_sweep : one level-synchronous construction step at full scale
                (n = 2^24 vertices ~ USA's 23.9M, k = 20 = the paper's
                default, level batch 131072, tau = 32 > every Table-2 tau)
  serve_batch : 2^20 concurrent kNN queries against the index

These are the shapes the on-card kernel check runs at.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class KNNIndexConfig:
    name: str
    n_vertices: int = 1 << 24
    k: int = 20
    level_batch: int = 131072
    tau: int = 32
    query_batch: int = 1 << 20


def make_config() -> KNNIndexConfig:
    return KNNIndexConfig(name="knn-index-usa")


def make_smoke() -> KNNIndexConfig:
    return KNNIndexConfig(
        name="knn-index-smoke", n_vertices=512, k=5, level_batch=64, tau=4, query_batch=32
    )
