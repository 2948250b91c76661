"""Host milliseconds a query batch spends inside ``QueryEngine.query_batch``
before the synchronize (its uploads and enqueued gathers), mean over the
window's batches; the benchmark's own span around the call."""


def read(run):
    if run.kind != "serve" or not run.ops:
        return None
    return 1e3 * sum(o.enqueued - o.start for o in run.ops) / len(run.ops)
