"""Queries answered in the window over the window's time (host clock, each
operation synchronized), in queries/s."""


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return sum(o.items for o in run.ops) / run.window_s
