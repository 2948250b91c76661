"""Milliseconds of a traced build in which the device was idle while the
host was inside the program's ``repro_torch.object_extras`` span, mean over
the traced builds."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "build")
    if trace is None or not trace.device:
        return None
    extras = spans.intervals(trace, spans.OBJECT_EXTRAS, inside=spans.BUILD)
    return spans.per_op_ms(run, spans.idle_s(trace, extras)) if extras else None
