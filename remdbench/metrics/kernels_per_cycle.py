"""Kernels the device ran in the traced window, over its exchange
cycles."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["cycles"]
