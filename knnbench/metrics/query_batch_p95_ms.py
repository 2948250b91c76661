"""The 95th percentile over every operation of the window, from the call to
the synchronize after it (host clock), in ms."""
import numpy as np


def read(run):
    if not run.ops:
        return None
    return float(np.percentile([1e3 * (o.end - o.start) for o in run.ops], 95))
