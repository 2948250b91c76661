"""Bytes the last query batch of a traced run uploaded to the device: the
program's ``h2d_bytes`` counter of its last ``repro_torch.query_batch``
(``repro_torch.trace.last``), read after the window; every batch of a cell
has the same shape."""
from knnbench import spans


def read(run):
    if spans.traced(run, "serve") is None:
        return None
    return spans.last_count(spans.QUERY_BATCH, "h2d_bytes")
