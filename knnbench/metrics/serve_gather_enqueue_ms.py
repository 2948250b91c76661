"""Host milliseconds a traced query batch spends enqueueing its gather: the
program's ``repro_torch.gather_batch`` span less the uploads inside it (the
id fix-up, the row gathers, the mask), mean over the traced batches."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "serve")
    if trace is None:
        return None
    gather = spans.intervals(trace, spans.GATHER_BATCH, inside=spans.QUERY_BATCH)
    if not gather:
        return None
    uploads = spans.intervals(trace, spans.UPLOAD, inside=spans.GATHER_BATCH)
    return spans.per_op_ms(run, spans.length(gather) - spans.length(uploads))
