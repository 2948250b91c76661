"""Host milliseconds a traced query batch spends in its uploads: the
program's ``repro_torch.upload`` spans inside ``repro_torch.query_batch``
(the pageable copies of the query ids and the per-query k), mean over the
traced batches."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "serve")
    if trace is None:
        return None
    uploads = spans.intervals(trace, spans.UPLOAD, inside=spans.QUERY_BATCH)
    return spans.per_op_ms(run, spans.length(uploads)) if uploads else None
