"""The device-gated neighbor-list builds: ``ref.py`` (the masked O(N^2)
build of the JAX package's ``md/neighbors.py::build_dense`` and its cell
build ``build_cells``), ``ops.py`` (the gate's plain version, dispatch and
the ctypes wrappers) and the Hopper kernels ``csrc/nlist_build.cu`` and
``csrc/cell_build.cu``."""
