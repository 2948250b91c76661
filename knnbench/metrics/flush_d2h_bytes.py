"""Bytes the last flush of a traced run read back from the device: the
program's ``d2h_bytes`` counter of its last ``repro_torch.flush_updates``
(``repro_torch.trace.last``), read after the window."""
from knnbench import flushcost, spans


def read(run):
    if spans.traced(run, "fleet") is None:
        return None
    return spans.last_count(flushcost.FLUSH, "d2h_bytes")
