"""Host-side packing + dispatch for the bonded-force kernel.

``build_pack(system)`` converts a system's bonded topology into the
tables the CUDA kernel reads, once: per-role atom indices, parameter
rows and the (N, S) slot table.  Unlike the TPU kernel, no one-hot
gather matrix is built (at N = 2881 it would be 2944 x 26496 f32).

``bonded_forces`` is the one MD-facing entry point: a CUDA stack goes
through the kernel (``chain_forces_batched``, which launches
``csrc/chain_forces.cu`` and counts the launch), a CPU stack through the
dense PyTorch oracle (``ref.bonded_forces``, the JAX package's CPU path).
The kernel's plain version, the same two phases in PyTorch, is
``ref.bonded_forces_sparse``.  Umbrella centers and constants reach the
kernel as one (R, 8) row per replica (``pack_bias``); without them the
kernel's ``bias=False`` variant runs.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.chain_forces import ref

LIBRARY = KernelLibrary(
    "chain_forces", Path(__file__).parent / "csrc" / "chain_forces.cu")


class ChainForcePack(NamedTuple):
    """Kernel-ready bonded topology (static ints + device tensors)."""
    n_atoms: int
    top: ref.ChainTopology    # tensor topology for the PyTorch paths
    slots: ref.BondedSlots    # (N, S) inverted incidence
    bonds: torch.Tensor       # (B, 2) int32
    angles: torch.Tensor      # (A, 3) int32
    quads: torch.Tensor       # (Q, 4) int32
    bond_par: torch.Tensor    # (2, B): rows r0, k
    ang_par: torch.Tensor     # (2, A): rows t0, k
    quad_par: torch.Tensor    # (3, Q): rows n, k, phase
    slot_idx: torch.Tensor    # (N, S) int32 flat edge slots
    slot_sign: torch.Tensor   # (N, S) f32


def build_pack(system) -> ChainForcePack:
    """Pack a system's bonded topology (host-side, once), on the
    system's device."""
    top = ref.chain_topology(system)
    slots = ref.bonded_slots(top)

    def i32(t):
        return t.to(torch.int32).contiguous()

    return ChainForcePack(
        n_atoms=int(system.n_atoms), top=top, slots=slots,
        bonds=i32(top.bonds), angles=i32(top.angles), quads=i32(top.quads),
        bond_par=torch.stack([top.bond_r0, top.bond_k]).contiguous(),
        ang_par=torch.stack([top.angle_t0, top.angle_k]).contiguous(),
        quad_par=torch.stack([top.quad_n, top.quad_k,
                              top.quad_phase]).contiguous(),
        slot_idx=i32(slots.idx), slot_sign=slots.sign.contiguous(),
    )


def pack_bias(umbrella_center, umbrella_k, n_replicas: int, device):
    """The (R, 8) bias rows of the kernel: columns 0..U-1 the centers,
    2..2+U-1 the force constants (U in {1, 2}), zeros elsewhere."""
    b = torch.zeros((n_replicas, 8), dtype=torch.float32, device=device)
    if umbrella_center is not None:
        n_u = umbrella_center.shape[-1]
        b[:, 0:n_u] = umbrella_center
        b[:, 2:2 + n_u] = umbrella_k
    return b


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def chain_forces_batched(pos: torch.Tensor, pack: ChainForcePack,
                         bias: Optional[torch.Tensor] = None):
    """The kernel: a CUDA (R, N, 3) stack -> (forces (R, N, 3),
    e_bonded (R,)) in one launch; anything else raises.  ``bias``: the
    (R, 8) rows of :func:`pack_bias` (the ``bias=True`` variant), or
    None (the ``bias=False`` variant)."""
    r, n, _ = pos.shape
    nb, na, nq = (pack.bonds.shape[0], pack.angles.shape[0],
                  pack.quads.shape[0])
    w = pack.top.edge_width
    s = pack.slots.n_slots
    tables = (pack.bonds, pack.bond_par, pack.angles, pack.ang_par,
              pack.quads, pack.quad_par, pack.slot_idx, pack.slot_sign)
    check_cuda((pos,) + tables,
               ("pos", "bonds", "bond_par", "angles", "ang_par", "quads",
                "quad_par", "slot_idx", "slot_sign"))
    if pos.dtype != torch.float32 or n != pack.n_atoms:
        raise ValueError(f"pos must be float32 (R, {pack.n_atoms}, 3), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if bias is not None:
        check_cuda((bias,), ("bias",))
        if bias.dtype != torch.float32 or tuple(bias.shape) != (r, 8):
            raise ValueError(f"bias must be float32 ({r}, 8), got "
                             f"{bias.dtype} {tuple(bias.shape)}")
    fn = LIBRARY.function("chain_forces_launch", _ARGTYPES)
    edges = torch.empty((r, 6 * w, 3), dtype=torch.float32,
                        device=pos.device)
    term_e = torch.empty((r, 3, w), dtype=torch.float32, device=pos.device)
    force = torch.empty_like(pos)
    energy = torch.empty(r, dtype=torch.float32, device=pos.device)
    ptrs = [t.data_ptr() for t in (pos,) + tables]
    ptrs += [None if bias is None else bias.data_ptr()]
    ptrs += [t.data_ptr() for t in (edges, term_e, force, energy)]
    code = fn(*ptrs, r, n, nb, na, nq, w, s, stream_ptr())
    raise_on_error(code, "chain_forces")
    LIBRARY.count("bias" if bias is not None else "plain")
    return force, energy


def bonded_forces(pos: torch.Tensor, pack: ChainForcePack,
                  umbrella_center: Optional[torch.Tensor] = None,
                  umbrella_k: Optional[torch.Tensor] = None):
    """(R, N, 3) stack -> (forces (R, N, 3), e_bonded (R,)): analytic
    bonds + angles + torsions (+ the umbrella torque when centers are
    given, (R, U) each).  The CUDA kernel on the card, the dense PyTorch
    oracle on the CPU."""
    if default_use_kernel(pos):
        bias = (None if umbrella_center is None else
                pack_bias(umbrella_center, umbrella_k, pos.shape[0],
                          pos.device))
        return chain_forces_batched(pos.contiguous(), pack, bias)
    return ref.bonded_forces(pos, pack.top, umbrella_center, umbrella_k)
