"""The noise stream of the fused propagate path.

The counterpart of the JAX package's ``md/noise.py``:
``step_noise_unrolled(rngs, t, shape)`` draws iteration ``t``'s block
``normal(fold_in(key_r, t), shape)`` for every replica in threefry's
legacy counter layout (``kernels/noise/ref.py`` says how), bitwise the
JAX fused path's stream.  On the card one launch of the noise kernel
draws it (``kernels/noise/csrc/threefry_normal.cu``), where XLA fuses
the JAX package's unrolled hash into the loop body; on the CPU the
plain version does.
"""
from __future__ import annotations

from repro_torch.kernels.noise.ops import step_noise_unrolled

__all__ = ["step_noise_unrolled"]
