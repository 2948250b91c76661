"""The flush's spans and the least work of its K3 launches.

The spans and counters are the program's (``repro_torch.trace``, kept by
``EngineCore.flush_updates``); a program without them gives nothing, and
the readers that use them read nothing.

K3's least bytes, the rule the program's ``k3_bytes`` counter keeps for
each ``frontier_relax_rows`` launch over R receivers and B source columns:
each receiver's live neighbour slots once, with their weights (8 B a slot);
each distinct neighbour's B-column row of the state once; each receiver's
B-column row of the result once (4 B a column). It is counted from the
BN-Graph's real slots and the frontier's real sources, never from what a
kernel happens to read, so a share of the roofline reads the same work
whatever implements K3 and cannot pass 100%.
"""
from __future__ import annotations

from knnbench.yardstick import least_seconds

FLUSH = "repro_torch.flush_updates"
FRONTIER = "repro_torch.flush.frontier"
REPAIR = "repro_torch.flush.repair"
K3_KERNEL = "frontier_relax_kernel"


def k3_least_bytes(slots: int, neighbours: int, receivers: int, b: int) -> int:
    """One launch: ``slots`` live neighbour slots of its ``receivers`` rows,
    ``neighbours`` distinct neighbours, ``b`` source columns."""
    return 8 * slots + 4 * b * (neighbours + receivers)


def least_s(k3_bytes: int) -> float:
    """The least seconds of a flush's K3 launches: their bytes at HBM bandwidth."""
    return least_seconds(k3_bytes, 0)
