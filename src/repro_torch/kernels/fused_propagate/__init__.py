"""The fused BAOAB propagate: ``ref.py`` (the PyTorch oracle of one
iteration), ``ops.py`` (the ctypes wrapper, the kernel's plain version,
the iteration loop) and ``csrc/fused_baoab.cu`` (the Hopper kernel)."""
