"""Chain nonbonded pass (LJ + Coulomb over all pairs): ``ref.py``
(PyTorch oracle), ``ops.py`` (packing, dispatch, the ctypes wrapper and
the kernel's plain version) and ``csrc/nonbonded.cu`` (the Hopper
kernel)."""
