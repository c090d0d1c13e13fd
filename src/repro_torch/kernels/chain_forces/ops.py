"""Host-side packing + dispatch for the bonded-force kernel.

``build_pack(system)`` converts a system's bonded topology into the
tables the CUDA kernel reads, once: per-role atom indices, parameter
rows, the (N, S) slot table, and the per-block term tables of
``block_tables`` (which terms each block of ``BLOCK_ATOMS`` atoms
computes, where their edges sit in the block's shared memory, which
block owns each term's energy, and each atom's slots renumbered into its
block's edges).  Unlike the TPU kernel, no one-hot gather matrix is
built (at N = 2881 it would be 2944 x 26496 f32).

``bonded_forces`` is the one MD-facing entry point: a CUDA stack goes
through the kernel (``chain_forces_batched``, which launches
``csrc/chain_forces.cu``, two CUDA launches per call, and counts the
call once), a CPU stack through the dense PyTorch oracle
(``ref.bonded_forces``, the JAX package's CPU path) or, for
``bonded="sparse"``, the slot-table one.  The kernel's plain version,
the per-edge gradients and the slot sums in PyTorch, is
``ref.bonded_forces_sparse``.  Umbrella centers and constants reach the
kernel as one (R, 8) row per replica (``pack_bias``); without them the
kernel's ``bias=False`` variant runs.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import (KernelLibrary, check_cuda,
                                 default_use_kernel, raise_on_error,
                                 stream_ptr)
from repro_torch.kernels.chain_forces import ref

LIBRARY = KernelLibrary(
    "chain_forces", Path(__file__).parent / "csrc" / "chain_forces.cu")


BLOCK_ATOMS = 256   # atoms per block of the kernel; kBlockAtoms in
                    # csrc/chain_forces.cu
OWNER = 1 << 30     # the owner flag of a listed term; kOwner there
EDGES_PER_CLASS = (1, 2, 3)        # bond, angle, torsion
# local edge of each role of the slot layout (role * W + w): bond d;
# angle v1, v2; torsion b0, b1, b2
ROLE_CLASS = np.array([0, 1, 1, 2, 2, 2])
ROLE_OFFSET = np.array([0, 0, 1, 0, 1, 2])


class BlockTables(NamedTuple):
    """The kernel's per-block term tables (host-built, once).  Block b
    lists terms ``terms[term_ptr[b]:term_ptr[b + 1]]``: global term
    indices t (bond t, angle t - B, torsion t - B - A) in ascending
    order, ``| OWNER`` on the one block that sums the term's energy (the
    block of its first atom); the term's edges sit at local slots
    ``term_edge[k]`` and on, in role order.  ``slot_loc`` (N, S) renumbers
    each atom's slots into its block's local edges (0 for padding);
    ``slot_code`` (S, N) is what the kernel reads: ``slot_loc << 2`` | 1
    for sign +1, | 2 for -1, 0 for padding, slot-rank major."""
    term_ptr: np.ndarray    # (n_blocks + 1,) int32
    terms: np.ndarray       # (T,) int32
    term_edge: np.ndarray   # (T,) int32
    slot_loc: np.ndarray    # (N, S) int32
    slot_code: np.ndarray   # (S, N) int32
    max_edges: int          # the most local edges of any block


def block_tables(top: ref.ChainTopology, slots: ref.BondedSlots,
                 block_atoms: int = BLOCK_ATOMS) -> BlockTables:
    """The per-block term tables of a topology: every term with an atom in
    a block is listed in that block, whatever the atoms' order (a
    non-local topology lists more terms per block, nothing else)."""
    sets = [t.cpu().numpy() for t in (top.bonds, top.angles, top.quads)]
    counts = [len(a) for a in sets]
    first = np.concatenate([[0], np.cumsum(counts)])
    term_of = np.concatenate([first[c] + np.repeat(np.arange(len(a)),
                                                   a.shape[1])
                              for c, a in enumerate(sets)])
    block_of = np.concatenate([a.reshape(-1) for a in sets]) // block_atoms
    n_terms = int(first[-1])
    keys = np.unique(block_of.astype(np.int64) * n_terms + term_of)
    blk, term = keys // n_terms, keys % n_terms
    cls = np.searchsorted(first[1:], term, side="right")
    width = np.asarray(EDGES_PER_CLASS)[cls]
    n = slots.idx.shape[0]
    n_blocks = -(-n // block_atoms)
    term_ptr = np.searchsorted(blk, np.arange(n_blocks + 1))
    ends = np.cumsum(width)
    term_edge = ends - width - np.repeat(
        np.concatenate([[0], ends])[term_ptr[:-1]], np.diff(term_ptr))
    owner = np.concatenate([a[:, 0] for a in sets]) // block_atoms
    flags = np.where(owner[term] == blk, OWNER, 0)
    # each atom's slots: flat f = role W + w -> term, local edge
    w = top.edge_width
    flat = slots.idx.cpu().numpy()
    role, wi = flat // w, flat % w
    t_of_slot = first[ROLE_CLASS[role]] + wi
    atom_blk = np.arange(n)[:, None] // block_atoms
    at = np.searchsorted(keys, atom_blk * n_terms + t_of_slot)
    at = np.minimum(at, len(keys) - 1)
    loc = term_edge[at] + ROLE_OFFSET[role]
    sign = slots.sign.cpu().numpy()
    loc = np.where(sign == 0, 0, loc)
    code = (loc << 2) | np.where(sign > 0, 1, np.where(sign < 0, 2, 0))
    per_block = np.diff(np.concatenate([[0], ends])[term_ptr])
    return BlockTables(term_ptr=term_ptr.astype(np.int32),
                       terms=(term | flags).astype(np.int32),
                       term_edge=term_edge.astype(np.int32),
                       slot_loc=loc.astype(np.int32),
                       slot_code=np.ascontiguousarray(code.T, np.int32),
                       max_edges=int(per_block.max()))


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
    blocks: BlockTables       # the kernel's per-block tables (host)
    term_ptr: torch.Tensor    # their device copies, int32
    terms: torch.Tensor
    term_edge: torch.Tensor
    slot_code: torch.Tensor


def build_pack(system) -> ChainForcePack:
    """Pack a system's bonded topology (host-side, once), on the
    system's device."""
    top = ref.chain_topology(system)
    slots = ref.bonded_slots(top)
    blocks = block_tables(top, slots)
    dev = system.masses.device

    def i32(t):
        return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()

    return ChainForcePack(
        n_atoms=int(system.n_atoms), top=top, slots=slots,
        bonds=i32(top.bonds), angles=i32(top.angles), quads=i32(top.quads),
        bond_par=torch.stack([top.bond_r0, top.bond_k]).contiguous(),
        ang_par=torch.stack([top.angle_t0, top.angle_k]).contiguous(),
        quad_par=torch.stack([top.quad_n, top.quad_k,
                              top.quad_phase]).contiguous(),
        slot_idx=i32(slots.idx), slot_sign=slots.sign.contiguous(),
        blocks=blocks, term_ptr=i32(blocks.term_ptr),
        terms=i32(blocks.terms), term_edge=i32(blocks.term_edge),
        slot_code=i32(blocks.slot_code),
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


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def chain_forces_batched(pos: torch.Tensor, pack: ChainForcePack,
                         bias: Optional[torch.Tensor] = None):
    """The kernel: a CUDA (R, N, 3) stack -> (forces (R, N, 3),
    e_bonded (R,)) in one call (the per-block terms and slot sums, then
    the block sums of the energy in order); anything else raises.
    ``bias``: the (R, 8) rows of :func:`pack_bias` (the ``bias=True``
    variant), or None (the ``bias=False`` variant)."""
    r, n, _ = pos.shape
    nb, na, nq = (pack.bonds.shape[0], pack.angles.shape[0],
                  pack.quads.shape[0])
    tables = (pack.bonds, pack.bond_par, pack.angles, pack.ang_par,
              pack.quads, pack.quad_par, pack.term_ptr, pack.terms,
              pack.term_edge, pack.slot_code)
    check_cuda((pos,) + tables,
               ("pos", "bonds", "bond_par", "angles", "ang_par", "quads",
                "quad_par", "term_ptr", "terms", "term_edge", "slot_code"))
    if pos.dtype != torch.float32 or n != pack.n_atoms:
        raise ValueError(f"pos must be float32 (R, {pack.n_atoms}, 3), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if bias is not None:
        check_cuda((bias,), ("bias",))
        if bias.dtype != torch.float32 or tuple(bias.shape) != (r, 8):
            raise ValueError(f"bias must be float32 ({r}, 8), got "
                             f"{bias.dtype} {tuple(bias.shape)}")
    fn = LIBRARY.function("chain_forces_launch", _ARGTYPES)
    e_part = torch.empty((r, pack.term_ptr.shape[0] - 1),
                         dtype=torch.float32, device=pos.device)
    force = torch.empty_like(pos)
    energy = torch.empty(r, dtype=torch.float32, device=pos.device)
    ptrs = [t.data_ptr() for t in (pos,) + tables]
    ptrs += [None if bias is None else bias.data_ptr()]
    ptrs += [t.data_ptr() for t in (e_part, force, energy)]
    code = fn(*ptrs, r, n, nb, na, nq, pack.slots.n_slots,
              pack.blocks.max_edges, stream_ptr())
    raise_on_error(code, "chain_forces")
    LIBRARY.count("bias" if bias is not None else "plain")
    return force, energy


def bonded_forces(pos: torch.Tensor, pack: ChainForcePack,
                  umbrella_center: Optional[torch.Tensor] = None,
                  umbrella_k: Optional[torch.Tensor] = None,
                  sparse: bool = False):
    """(R, N, 3) stack -> (forces (R, N, 3), e_bonded (R,)): analytic
    bonds + angles + torsions (+ the umbrella torque when centers are
    given, (R, U) each).  The CUDA kernel on the card either way; on the
    CPU the dense PyTorch oracle, or with ``sparse`` the slot-table
    contraction (``ref.bonded_forces_sparse``), as the JAX package's
    ``bonded="sparse"`` selects on its jnp path."""
    if default_use_kernel(pos):
        bias = (None if umbrella_center is None else
                pack_bias(umbrella_center, umbrella_k, pos.shape[0],
                          pos.device))
        return chain_forces_batched(pos.contiguous(), pack, bias)
    if sparse:
        return ref.bonded_forces_sparse(pos, pack.top, pack.slots,
                                        umbrella_center, umbrella_k)
    return ref.bonded_forces(pos, pack.top, umbrella_center, umbrella_k)
