"""Host milliseconds a traced tick's flush spends in its checkIns frontier
(the rounds of K3, the receivers' expansion, the candidates' compaction):
the program's ``repro_torch.flush.frontier`` span, mean over the traced
ticks."""
from knnbench import flushcost, spans


def read(run):
    trace = spans.traced(run, "fleet")
    if trace is None:
        return None
    frontier = spans.intervals(trace, flushcost.FRONTIER, inside=flushcost.FLUSH)
    return spans.per_op_ms(run, spans.length(frontier)) if frontier else None
