"""Causal / sliding-window attention, forward only: ``ref.py`` (the
plain PyTorch version, the CPU path and the kernel's oracle), ``ops.py``
(dispatch and the ctypes wrapper) and ``csrc/flash_attention.cu`` (the
Hopper kernel)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
