"""K-hop neighbour sampling over CSR graphs (the `minibatch_lg` substrate):
the port's own copy of ``repro/graph/sampler.py``, over ``graph/csr.py``'s
``Graph``, giving the same arrays for the same graph, seeds and seed.

GraphSAGE-style uniform fanout sampling (arXiv:1706.02216): per layer, each
frontier node samples up to `fanout` neighbours without replacement. It runs
on the host (numpy); the sampled subgraph goes to the card as padded edge
arrays that the GNN train step takes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import Graph


@dataclasses.dataclass
class SampledSubgraph:
    nodes: np.ndarray        # (n_sub,) original node ids (position = local id)
    edge_index: np.ndarray   # (2, e_sub) local ids, dst = aggregation target
    seeds_local: np.ndarray  # (batch,) local ids of the seed nodes


def sample_khop(
    g: Graph, seeds: np.ndarray, fanouts: tuple[int, ...], *, seed: int = 0
) -> SampledSubgraph:
    rng = np.random.default_rng(seed)
    node_ids: list[int] = list(dict.fromkeys(seeds.tolist()))
    local = {v: i for i, v in enumerate(node_ids)}
    edges_src: list[int] = []
    edges_dst: list[int] = []
    frontier = list(node_ids)
    for fanout in fanouts:
        nxt: list[int] = []
        for v in frontier:
            nbrs, _ = g.neighbors(v)
            if len(nbrs) == 0:
                continue
            take = min(fanout, len(nbrs))
            picked = rng.choice(nbrs, size=take, replace=False)
            for u in picked.tolist():
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                    nxt.append(u)
                # message u -> v (aggregate into the frontier node)
                edges_src.append(local[u])
                edges_dst.append(local[v])
        frontier = nxt
        if not frontier:
            break
    return SampledSubgraph(
        nodes=np.asarray(node_ids, dtype=np.int64),
        edge_index=np.asarray([edges_src, edges_dst], dtype=np.int32),
        seeds_local=np.asarray([local[int(s)] for s in seeds], dtype=np.int32),
    )


def pad_subgraph(sub: SampledSubgraph, n_nodes_pad: int, n_edges_pad: int) -> SampledSubgraph:
    """Pad to static shapes (dummy node = last slot, self-edges as padding)."""
    n = len(sub.nodes)
    e = sub.edge_index.shape[1]
    if n > n_nodes_pad or e > n_edges_pad:
        raise ValueError(f"subgraph of {n} nodes, {e} edges past the pad "
                         f"({n_nodes_pad}, {n_edges_pad})")
    nodes = np.concatenate([sub.nodes, np.zeros(n_nodes_pad - n, np.int64)])
    dummy = n_nodes_pad - 1
    pad_e = np.full((2, n_edges_pad - e), dummy, np.int32)
    return SampledSubgraph(
        nodes=nodes,
        edge_index=np.concatenate([sub.edge_index, pad_e], axis=1),
        seeds_local=sub.seeds_local,
    )
