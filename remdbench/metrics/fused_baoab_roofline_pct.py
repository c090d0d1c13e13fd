"""Kernel 3 (``fused_propagate/csrc/fused_baoab.cu``: one masked BAOAB
iteration with the bonded, bias and nonbonded forces) against its bound
(``counts.chain.fused_bound`` for this chip's replicas) over its mean
device time per launch in the traced window, %."""
_NAME = "fused_baoab_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    times = [d for name, _, d in tr.kernels if _NAME in name]
    if not times:
        return None
    c = ctx["counts"]
    bound = c.fused_bound(ctx["topology"], ctx["replicas_per_chip"],
                          c.has_bias(ctx["config"]))["ms"]
    return 100.0 * bound / (sum(times) / 1e3 / len(times))
