"""The (R, C) cross-energy matrix of the Gibbs exchange: ``ref.py``
(PyTorch oracle and the kernel's plain version), ``ops.py`` (packing,
dispatch, the ctypes wrapper) and ``csrc/exchange_matrix.cu`` (the
Hopper kernel)."""
