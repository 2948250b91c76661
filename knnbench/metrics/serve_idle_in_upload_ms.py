"""Milliseconds of a traced query batch in which the device was idle while
the host was inside one of the program's ``repro_torch.upload`` spans (the
host side of the pageable copies), mean over the traced batches."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "serve")
    if trace is None or not trace.device:
        return None
    uploads = spans.intervals(trace, spans.UPLOAD, inside=spans.QUERY_BATCH)
    return spans.per_op_ms(run, spans.idle_s(trace, uploads)) if uploads else None
