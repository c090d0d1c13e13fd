"""The device-gated neighbor-list build: ``ref.py`` (the masked O(N^2)
build of the JAX package's ``md/neighbors.py::build_dense``), ``ops.py``
(the gate's plain version, dispatch and the ctypes wrapper) and
``csrc/nlist_build.cu`` (the Hopper kernel)."""
