"""Architecture configs of the dense family (the port's own copies of the
JAX package's ``repro.configs`` modules of the same names).

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
"""
