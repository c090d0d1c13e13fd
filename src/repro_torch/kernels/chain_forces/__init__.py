"""Analytic bonded forces: ``ref.py`` (PyTorch oracle + the kernel's
plain version), ``ops.py`` (packing, dispatch, the ctypes wrapper) and
``csrc/chain_forces.cu`` (the Hopper kernel)."""
