"""The whole cycle's share of the card's float32 peak: the operations one
exchange cycle needs on this chip's replicas (the system kind's
``counts`` module, ``cycle_ops``: for a chain ``md_steps + 1``
force-and-energy evaluations, the bias and the BAOAB updates, no
separate feature pass) over the time of a cycle untraced, timed just
before the traced window, times 67 TFLOP/s, %."""
from remdbench.counts.peaks import FP32_FLOPS_PER_S


def read(ctx):
    if ctx["trace"] is None or not ctx["trace"].kernels:
        return None
    ops = ctx["counts"].cycle_ops(ctx["topology"], ctx["config"],
                                  ctx["replicas_per_chip"])
    return 100.0 * ops / (ctx["cycle_s"] * FP32_FLOPS_PER_S)
