"""The telemetry's ``propagate`` phase probe (every replica's MD steps of
one cycle, alone on the current ensemble): the mean of its samples
after the traced window, ms."""


def read(ctx):
    s = ctx["phase_s"].get("propagate")
    return None if s is None else s * 1e3
