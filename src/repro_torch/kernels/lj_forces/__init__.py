"""Lennard-Jones passes: the LJ fluid of ``LJEngine`` (uniform sigma, eps,
minimum image) and the chain nonbonded pass (LJ + Coulomb) over all pairs
and over neighbor lists: ``ref.py`` (PyTorch oracles), ``ops.py``
(packing, dispatch, the ctypes wrappers and the kernels' plain versions),
``csrc/lj_fluid.cu``, ``csrc/nonbonded.cu`` and
``csrc/nonbonded_sparse.cu`` (the Hopper kernels)."""
