"""Host milliseconds a traced tick's flush spends repairing its deletion
holes (K2's repair-round tiles): the program's ``repro_torch.flush.repair``
span, mean over the traced ticks."""
from knnbench import flushcost, spans


def read(run):
    trace = spans.traced(run, "fleet")
    if trace is None:
        return None
    repair = spans.intervals(trace, flushcost.REPAIR, inside=flushcost.FLUSH)
    return spans.per_op_ms(run, spans.length(repair)) if repair else None
