"""Host milliseconds a traced query batch spends in the engine outside its
gather: the program's ``repro_torch.query_batch`` span less its
``repro_torch.gather_batch`` (input checks, the epoch, ``_ks_array``), mean
over the traced batches."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "serve")
    if trace is None:
        return None
    batch = spans.intervals(trace, spans.QUERY_BATCH)
    gather = spans.intervals(trace, spans.GATHER_BATCH, inside=spans.QUERY_BATCH)
    if not batch or not gather:
        return None
    return spans.per_op_ms(run, spans.length(batch) - spans.length(gather))
