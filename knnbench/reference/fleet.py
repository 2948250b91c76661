"""The comparison of a fleet run: fresh answers, and an index kept exact.

For each sampled tick, the exact table of that tick's object set comes
from the Bellman fixed point, and every answer of the tick's batch must
equal its exact row; Dijkstra recomputes the picked answers. After the
window the engine's published table is judged whole against the final
object set (``bellman.failing_rows``). Counts of wrong things, limit 0, under
the names of ``judge.LIMITS``.
"""
from __future__ import annotations

import numpy as np
import torch

from knnbench.reference.bellman import Bellman
from knnbench.reference.dijkstra import Dijkstra
from knnbench.reference.judge import _dijkstra_row_wrong, _mask


def judge_fleet(bell: Bellman, dij: Dijkstra, k: int, ticks, final, picks) -> dict:
    """``ticks``: (objects, us, out_ids, out_d, exact) of the sampled ticks,
    ``exact`` the (ids, d) table of ``objects`` or None (computed here);
    ``final``: (objects, ids, d), the published table after the window;
    ``picks``: (tick, position) pairs that Dijkstra recomputes."""
    dev = bell.device
    wrong = 0
    for t, (objects, us, out_ids, out_d, exact) in enumerate(ticks):
        if tuple(out_ids.shape) != (len(us), k) or tuple(out_d.shape) != (len(us), k):
            wrong += len(us)
            continue
        e_ids, e_d = exact if exact is not None else bell.fixed_point(objects, k)[:2]
        u = torch.from_numpy(us.astype(np.int64)).to(dev)
        got_ids, got_d = out_ids.to(dev), out_d.to(dev)
        bad = ((got_ids != e_ids[u]) | (got_d != e_d[u])).any(dim=1)
        is_object = _mask(bell.n, objects)
        for pt, pos in picks:
            if pt == t and not bool(bad[pos]):
                bad[pos] = _dijkstra_row_wrong(dij, is_object, int(us[pos]), k, k,
                                               got_ids[pos].cpu().numpy(),
                                               got_d[pos].cpu().numpy())
        wrong += int(bad.sum())
    objects, ids, d = final
    rows = int(bell.failing_rows(ids, d, objects).sum())
    return {"wrong_answers": wrong, "wrong_rows": rows}
