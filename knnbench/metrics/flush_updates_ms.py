"""Host milliseconds a traced tick spends in ``flush_updates``: the
program's ``repro_torch.flush_updates`` span, mean over the traced ticks."""
from knnbench import flushcost, spans


def read(run):
    trace = spans.traced(run, "fleet")
    if trace is None:
        return None
    flush = spans.intervals(trace, flushcost.FLUSH)
    return spans.per_op_ms(run, spans.length(flush)) if flush else None
