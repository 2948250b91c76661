"""Share of the roofline K2 ``sweep_merge_levels`` reaches in a traced
build: the least time of both sweeps' work (yardstick.sweep_work, from the
BN-Graph's real neighbour slots) over the device time of the kernels named
``sweep_levels_kernel``, in %."""


def read(run):
    if run.kind != "build" or run.trace is None or not run.traced_ops:
        return None
    seconds = run.trace.kernel_s("sweep_levels_kernel")
    if seconds <= 0:
        return None
    return 100.0 * sum(run.least_s[o.pool] for o in run.traced_ops) / seconds
