"""Host milliseconds a traced build spends enqueueing its two sweeps: the
program's ``repro_torch.run_sweep.up`` and ``.down`` spans, mean over the
traced builds."""
from knnbench import spans


def read(run):
    trace = spans.traced(run, "build")
    if trace is None:
        return None
    sweeps = [iv for name in spans.SWEEPS for iv in spans.intervals(trace, name, inside=spans.BUILD)]
    return spans.per_op_ms(run, spans.length(sweeps)) if sweeps else None
