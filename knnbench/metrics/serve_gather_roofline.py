"""Share of the roofline a traced query batch reaches: the least time the
batch's bytes take at HBM bandwidth (yardstick.serve_batch_bytes) over the
device-busy time of the batch (uploads, gathers and masks), in %."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.traced_ops or not run.trace.device:
        return None
    least = sum(run.least_s[o.pool] for o in run.traced_ops)
    return 100.0 * least / run.trace.busy_s
