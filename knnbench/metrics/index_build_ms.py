"""The window's time over the operations (index builds) completed in it
(host clock, each synchronized), in ms."""


def read(run):
    if not run.ops:
        return None
    return 1e3 * run.window_s / len(run.ops)
