"""Share of a cycle in which no operation runs on the device: 100 (1 -
busy / cycle), the busy time per cycle the union of kernel, memcpy and
memset intervals in the profiler's trace over the traced window's
cycles, the cycle's time that of the untraced stretch timed just before
the window (the profiler slows a host-bound cycle; the device's work
hardly)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device or ctx["cycle_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / ctx["cycles"] / ctx["cycle_s"])
