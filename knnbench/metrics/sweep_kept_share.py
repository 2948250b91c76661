"""Share of the candidates K2's two sweeps gathered that they kept past
their rows' bounds, in the last build of a traced run: the program's
``k2_kept`` over ``k2_gathered`` counters of its last
``repro_torch.build_knn_tables`` (``repro_torch.trace.last``), read after
the window, in %. Only the kernel counts them: nothing on the plain path or
from a program without the counters."""
from knnbench import spans


def read(run):
    if spans.traced(run, "build") is None:
        return None
    gathered = spans.last_count(spans.BUILD, "k2_gathered")
    kept = spans.last_count(spans.BUILD, "k2_kept")
    if not gathered or kept is None:
        return None
    return 100.0 * kept / gathered
