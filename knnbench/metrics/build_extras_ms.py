"""Host milliseconds a traced build spends in ``object_extras`` (its host
numpy and its two uploads): the program's ``repro_torch.object_extras``
span, mean over the traced builds."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "build")
    if trace is None:
        return None
    extras = spans.intervals(trace, spans.OBJECT_EXTRAS, inside=spans.BUILD)
    return spans.per_op_ms(run, spans.length(extras)) if extras else None
