"""Chain nonbonded pass (LJ + Coulomb), over all pairs and over neighbor
lists: ``ref.py`` (PyTorch oracles), ``ops.py`` (packing, dispatch, the
ctypes wrappers and the kernels' plain versions), ``csrc/nonbonded.cu``
and ``csrc/nonbonded_sparse.cu`` (the Hopper kernels)."""
