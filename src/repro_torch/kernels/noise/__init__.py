"""Gaussian noise from threefry bits in one pass: ``ref.py`` (the plain
versions: the legacy-layout block of the fused propagate, the stacked
per-step draw and the SGLD update), ``ops.py`` (dispatch and the ctypes
wrappers) and the Hopper kernel ``csrc/threefry_normal.cu``."""
