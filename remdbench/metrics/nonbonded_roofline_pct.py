"""Kernel 2 (``lj_forces/csrc/nonbonded.cu``: the pair walk and the sum of
its partial rows) against its bound: the least time the card could take
for one call on this chip's replicas (``counts.chain.nonbonded_bound``,
operations or bytes from the topology over the H100's published peaks)
over its mean device time per call in the traced window, %."""
_CALL = "nonbonded_pairs_kernel"
_PARTS = (_CALL, "nonbonded_combine_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    calls = sum(1 for name, _, _ in tr.kernels if _CALL in name)
    if not calls:
        return None
    us = sum(d for name, _, d in tr.kernels
             if any(p in name for p in _PARTS))
    bound = ctx["counts"].nonbonded_bound(ctx["topology"],
                                          ctx["replicas_per_chip"])["ms"]
    return 100.0 * bound / (us / 1e3 / calls)
