"""Hand-written CUDA kernels for the port's hot spots.

  chain_forces    — analytic bonded forces (bonds, angles, torsions,
                    optional umbrella torque) and the bonded energy;
                    replaces the JAX package's
                    ``chain_forces_kernel_batched`` Pallas kernel.
  lj_forces       — LJ + Coulomb forces and energies, over all pairs with
                    an exclusion mask (replaces ``nonbonded_kernel_batched``)
                    and over a neighbor list (replaces
                    ``nonbonded_sparse_kernel_batched``); the LJ fluid's
                    energy and forces under the minimum image (replace
                    ``lj_energy_kernel_batched``, ``lj_forces_kernel_batched``).
  fused_propagate — one masked BAOAB iteration (bonded + nonbonded force
                    and the update) per launch; replaces
                    ``fused_baoab_kernel_batched``.
  exchange_matrix — the (R, C) replica x ctrl reduced-energy matrix of the
                    Gibbs exchange; replaces ``exchange_matrix_kernel``.
  nlist_build     — the neighbor-list builds, gated on a device flag:
                    the masked dense build (``nlist_build.cu``) and the
                    cell-list build (``cell_build.cu``); no TPU
                    counterpart (the JAX package builds the list with jnp
                    under ``lax.cond``), they are the port's form of that
                    cond.
  flash_attention — causal / sliding-window attention, forward only,
                    the model layout with grouped kv heads; replaces
                    ``flash_attention_kernel``.  Every prefill attention
                    of the LM on the card.
  noise           — the threefry hash and the bits -> normal map in one
                    pass (the stacked and legacy-layout draws, the SGLD
                    update); no TPU counterpart, the port's form of
                    XLA's elementwise fusion of the jnp hash.

Each subpackage: ``csrc/*.cu`` (CUDA C++ for ``sm_90a`` with a plain C
entry point), ``ops.py`` (the ctypes wrappers with their launch counters,
the MD-facing entry points, and the kernels' plain versions where they
are not oracles of ``ref.py``: ``nonbonded_plain``,
``build_gated_plain``), ``ref.py`` (the PyTorch oracles, which are also
the CPU path and the other kernels' plain versions).  An entry point
dispatches by device: a CUDA tensor goes to the kernel, which launches
or raises, a CPU tensor to the oracle.

Build: ``KernelLibrary.load`` compiles one source with ``nvcc`` into a
shared library under ``build/repro_torch/`` (cached by a hash of the
source, the shared headers of ``csrc/`` and the flags) at first use, and
loads it with ``ctypes``.  Device code that two kernels share lives once
in ``csrc/``: the bonded terms and the neighbor-list pair term in
``md_terms.cuh``, the all-pairs tile walk (each unordered pair once, for
``nonbonded.cu`` and ``lj_fluid.cu``'s forces and energy kernels) in
``pair_tiles.cuh``, the two list builds' distance and list copy in
``nlist_common.cuh``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
REPLICA_CHUNK = 8   # replicas per chunk of the plain (R, N, N) pair planes


def pad_to_block(n: int, block: int) -> int:
    """Padding of an atom axis up to a whole number of blocks."""
    return max(block, ((n + block - 1) // block) * block)


def f32_square(r: float) -> float:
    """``r * r`` rounded once to float32: the threshold JAX compares a
    float32 array with when given a Python float, and the one the kernels
    get, so a distance test agrees on both sides of the boundary."""
    return float(np.float32(r * r))


def wrap_deg(delta):
    """Wrap angle differences (degrees) to [-180, 180) with
    ``jnp.mod``'s sign convention (result takes the divisor's sign): the
    one definition the bias energies and the bias torque share."""
    x = delta + 180.0
    rem = torch.fmod(x, 360.0)
    rem = torch.where((rem != 0) & (rem < 0), rem + 360.0, rem)
    return rem - 180.0


def default_use_kernel(t: torch.Tensor) -> bool:
    """Kernels run exactly where the data lives on the card."""
    return t.is_cuda


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sass_census(library: Path) -> dict:
    """``{kernel: {opcode: count}}`` of a built library's SASS, read with
    ``cuobjdump -sass`` (beside ``nvcc``): each kernel's static
    instructions by opcode without its modifiers (``F2F.F64.F32`` counts
    as ``F2F``), the kernel named by its mangled symbol."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            cur = out.setdefault(line.split(":", 1)[1].strip(), {})
        elif cur is not None and line.startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].strip().rstrip(";").strip()
            if not ins or ins.startswith("/*"):
                continue
            words = ins.split()
            if words[0].startswith("@"):          # a predicate guard
                words = words[1:]
            op = words[0].split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return out


class KernelLibrary:
    """One CUDA source built into a ctypes-loaded shared library.

    ``launches`` counts the kernel launches the owning wrapper made, and
    ``variants`` the same launches by variant name where the wrapper has
    variants; the wrapper counts each launch (``count``) and nothing else
    touches them but callers that ``reset`` them to measure a run."""

    def __init__(self, name: str, source: Path, flags=()):
        self.name = name
        self.source = Path(source)
        self.flags = NVCC_FLAGS + tuple(flags)
        self.launches = 0
        self.variants = {}
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> Path:
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(SHARED_CSRC.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(self.flags).encode()
                                ).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Build the library unless it is cached, then load it; raise
        with the compiler's output if ``nvcc`` fails."""
        if self._lib is None:
            path = self.path
            if not path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [nvcc_path(), *self.flags, "-I", str(SHARED_CSRC),
                     "-o", str(tmp),
                     str(self.source)],
                    capture_output=True, text=True, check=False)
                self.build_seconds = time.perf_counter() - t0
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.source}:\n{self.build_log}")
                os.replace(tmp, path)
            self._lib = ctypes.CDLL(str(path))
        return self._lib

    def count(self, variant: Optional[str] = None) -> None:
        """One launch (of ``variant``)."""
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.variants = {}

    def function(self, name: str, argtypes):
        """The C entry point ``name``, returning a ``cudaError_t`` as int,
        with its ctypes signature declared."""
        fn = getattr(self.load(), name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        return fn


def check_cuda(tensors, names) -> None:
    """Validate what a kernel wrapper hands to C: CUDA, contiguous."""
    for t, name in zip(tensors, names):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")
