"""Milliseconds of a traced tick in which the device was idle while the
host was inside the flush's ``repro_torch.flush.frontier`` span (the host's
receiver expansion and the rounds' mask readbacks), mean over the traced
ticks."""
from knnbench import flushcost, spans


def read(run):
    trace = spans.traced(run, "fleet")
    if trace is None or not trace.device:
        return None
    frontier = spans.intervals(trace, flushcost.FRONTIER, inside=flushcost.FLUSH)
    return spans.per_op_ms(run, spans.idle_s(trace, frontier)) if frontier else None
