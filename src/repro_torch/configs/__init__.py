"""Architecture configs of the ported families, dense, moe (on GQA and on
MLA attention), hybrid, ssm, encdec and vlm (the port's own copies of the
JAX package's ``repro.configs`` modules of the same names).

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests).
"""
