"""Bytes the last build of a traced run uploaded to the device: the
program's ``h2d_bytes`` counter of its last ``repro_torch.build_knn_tables``
(``repro_torch.trace.last``), read after the window; every build of a cell
uploads the same shapes."""
from knnbench import spans


def read(run):
    if spans.traced(run, "build") is None:
        return None
    return spans.last_count(spans.BUILD, "h2d_bytes")
