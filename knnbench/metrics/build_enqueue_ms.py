"""Host milliseconds an index build spends inside ``build_knn_tables``
before the synchronize (``object_extras`` and the launches), mean over the
window's builds; the benchmark's own span around the call."""


def read(run):
    if run.kind != "build" or not run.ops:
        return None
    return 1e3 * sum(o.enqueued - o.start for o in run.ops) / len(run.ops)
