"""Where the port's entry points run.

Entry points (``MDEngine``, ``REMDDriver``) take an explicit ``device``
that defaults to ``"cuda"``.  Asking for CUDA on a machine without it
raises: the port never falls back to the CPU on its own.  The CPU runs
only when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev
