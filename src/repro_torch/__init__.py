"""PyTorch/CUDA port of the RepEx reproduction (the ``repro`` package).

Mirrors ``repro``'s layout (``core/``, ``md/``, ``kernels/``) so each
module's counterpart is easy to find; the JAX package stays the
reference the port is tested against.  Entry points run on CUDA unless
the caller asks for ``device="cpu"``.
"""
