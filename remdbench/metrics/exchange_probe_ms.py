"""The telemetry's ``exchange`` phase probe, which runs the exchange as
the cycle runs it, its feature pass included, alone on the current
ensemble: the mean of its samples after the traced window, ms."""


def read(ctx):
    s = ctx["phase_s"].get("exchange")
    return None if s is None else s * 1e3
