"""Share of the roofline K3 reaches in the traced ticks' flushes: the least
time of their K3 launches (``flushcost``: each tick's ``k3_bytes`` counter
at HBM bandwidth) over the device time of the kernels named
``frontier_relax_kernel``, in %. Nothing from a program without the counter."""
from knnbench import flushcost


def read(run):
    if run.kind != "fleet" or run.trace is None or not run.traced_ops:
        return None
    if any(o.pool not in run.least_s for o in run.traced_ops):
        return None
    seconds = run.trace.kernel_s(flushcost.K3_KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * sum(run.least_s[o.pool] for o in run.traced_ops) / seconds
