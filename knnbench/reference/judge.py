"""The comparison that decides ``correct``.

Every number it returns is a count of wrong things, and its limit is 0:
the answers are exact, so an exact comparison decides. A table row is wrong
when it differs from its Bellman relaxation on the benchmark's own network
(``bellman.failing_rows``: the whole table judged, not a sample) or, for the
rows Dijkstra recomputes, from Dijkstra's answer. A served answer is wrong
when it differs from its table row, when that row is wrong, or,
for the answers Dijkstra recomputes, from Dijkstra's answer.
"""
from __future__ import annotations

import numpy as np
import torch

from knnbench.reference.bellman import Bellman
from knnbench.reference.dijkstra import Dijkstra

LIMITS = {"wrong_answers": 0, "wrong_rows": 0}


def _dijkstra_row_wrong(dij: Dijkstra, is_object: np.ndarray, u: int, k: int, width: int,
                        got_ids: np.ndarray, got_d: np.ndarray) -> bool:
    want = dij.knn(is_object, k, u)
    want_ids = np.full(width, -1, np.int64)
    want_d = np.full(width, np.inf)
    for i, (o, dist) in enumerate(want):
        want_ids[i], want_d[i] = o, dist
    return not (np.array_equal(got_ids.astype(np.int64), want_ids)
                and np.array_equal(got_d.astype(np.float64), want_d))


def _mask(n: int, objects: np.ndarray) -> np.ndarray:
    is_object = np.zeros(n, bool)
    is_object[objects] = True
    return is_object


def judge_serve(bell: Bellman, dij: Dijkstra, objects: np.ndarray, table, batches,
                picks: list[tuple[int, int]]) -> dict:
    """``table``: the served (n+1, k) (ids, dists); ``batches``: (us, out_ids,
    out_d) of batches served at the table's k; ``picks``: (batch, position)
    pairs that Dijkstra recomputes."""
    dev = bell.device
    t_ids, t_d = (x.to(dev) for x in table)
    k = t_ids.shape[1]
    bad_rows = bell.failing_rows(t_ids, t_d, objects)
    is_object = _mask(bell.n, objects)
    wrong = 0
    for b, (us, out_ids, out_d) in enumerate(batches):
        if tuple(out_ids.shape) != (len(us), k) or tuple(out_d.shape) != (len(us), k):
            wrong += len(us)
            continue
        u = torch.from_numpy(us.astype(np.int64)).to(dev)
        got_ids, got_d = out_ids.to(dev), out_d.to(dev)
        bad = ((got_ids != t_ids[u]) | (got_d != t_d[u])).any(dim=1) | bad_rows[u]
        for pb, pos in picks:
            if pb == b and not bool(bad[pos]):
                bad[pos] = _dijkstra_row_wrong(
                    dij, is_object, int(us[pos]), k, k,
                    got_ids[pos].cpu().numpy(), got_d[pos].cpu().numpy())
        wrong += int(bad.sum())
    return {"wrong_answers": wrong, "wrong_rows": int(bad_rows.sum())}


def judge_build(bell: Bellman, dij: Dijkstra, builds, picks: list[tuple[int, int]]) -> dict:
    """``builds``: (objects, ids, dists) of built tables; ``picks``: (build,
    row) pairs that Dijkstra recomputes."""
    wrong = 0
    for b, (objects, ids, d) in enumerate(builds):
        bad = bell.failing_rows(ids, d, objects)
        if ids.shape[0] == bell.n + 1:
            is_object = _mask(bell.n, objects)
            for pb, row in picks:
                if pb == b and not bool(bad[row]):
                    bad[row] = _dijkstra_row_wrong(
                        dij, is_object, row, ids.shape[1], ids.shape[1],
                        ids[row].cpu().numpy(), d[row].cpu().numpy())
        wrong += int(bad.sum())
    return {"wrong_rows": wrong}
