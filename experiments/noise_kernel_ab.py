"""The noise kernel against an earlier version of its source, on one card.

Builds ``src/repro_torch/kernels/noise/csrc/threefry_normal.cu`` of this
tree and the same file of an earlier checkout (``--before``, e.g. a
``git archive`` of the parent commit unpacked into a git-ignored
directory), each with the flags ``kernels/noise/ops.py`` gives it, then:

  * prints each library's SASS census per kernel (``cuobjdump -sass``:
    the float <-> double conversions ``F2F``, the fp64 ``DMUL`` / ``DADD``
    / ``DFMA``, ``FFMA``, the funnel shifts ``SHF``, ``MUFU``, all);
  * holds this tree's kernel bitwise against the earlier one (itself
    bitwise the plain version) on the three entry points at the shapes
    timed below, and its map entry point against the plain
    ``random.bits_to_erf_inv`` on all 2^23 mantissas;
  * times the three entry points (device time a call, a CUDA graph of
    calls replayed, median) in turns: earlier, this tree's, this tree's,
    earlier, so that a clock drift shows as a spread.

Run from the repository root on a machine with a card:
``python3 experiments/noise_kernel_ab.py --before build/parent``.
It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import random as jr                     # noqa: E402
from repro_torch.kernels import (KernelLibrary, sass_census,  # noqa: E402
                                 stream_ptr)
from repro_torch.kernels.noise import ops as nz_ops      # noqa: E402

SOURCE = Path("src/repro_torch/kernels/noise/csrc/threefry_normal.cu")
SHAPE = (2881, 3)
OPS = ("F2F", "DMUL", "DADD", "DFMA", "FFMA", "FMUL", "FADD", "SHF",
       "IADD3", "LOP3", "MUFU")
I64, I32, VP = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p


def graph_ms(fn, calls: int, reps: int = 9) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


class Version:
    """One build of the source and its three entry points."""

    def __init__(self, tag: str, source: Path):
        self.tag = tag
        self.lib = KernelLibrary(f"threefry_normal_{tag}", source,
                                 nz_ops.FLAGS)

    def fn(self, name, argtypes):
        return self.lib.function(name, argtypes)

    def stacked(self, keys, steps):
        out = torch.empty((steps, keys.shape[0]) + SHAPE, device="cuda")
        self.fn("noise_stacked_launch", [VP, I32, I32, I64, VP, VP])(
            keys.data_ptr(), keys.shape[0], steps, out[0, 0].numel(),
            out.data_ptr(), stream_ptr())
        return out

    def unrolled(self, keys, t):
        out = torch.empty((keys.shape[0],) + SHAPE, device="cuda")
        self.fn("noise_unrolled_launch", [VP, I32, ctypes.c_uint, I64, VP,
                                          VP])(
            keys.data_ptr(), keys.shape[0], t, out[0].numel(),
            out.data_ptr(), stream_ptr())
        return out

    def sgld(self, p, key, std):
        out = torch.empty_like(p)
        self.fn("sgld_noise_launch", [VP, VP, VP, I64, I64, VP, VP])(
            p.data_ptr(), key.data_ptr(), std.data_ptr(), 0, p.numel(),
            out.data_ptr(), stream_ptr())
        return out


def census(v: Version) -> dict:
    out = {}
    for kernel, ops in sass_census(v.lib.path).items():
        short = next((k for k in ("unrolled", "stacked", "sgld", "map")
                      if k in kernel), kernel)
        out[short] = {op: ops.get(op, 0) for op in OPS}
        out[short]["all"] = sum(ops.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", required=True, type=Path,
                    help="the root of an earlier checkout")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "noise_kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("noise_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    before = Version("before", args.before / SOURCE)
    after = Version("after", ROOT / SOURCE)
    versions = [before, after]
    report = {"card": smi, "sass": {}, "diff": {}, "ms": {}}
    for v in versions:
        v.lib.load()
        report["sass"][v.tag] = census(v)
        for k, c in report["sass"][v.tag].items():
            print(f"SASS {v.tag} {k}: {c}")

    keys64 = jr.split(jr.key(0, "cuda"), 64)
    keys384 = jr.split(jr.key(0, "cuda"), 384)
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaf = torch.randn((50304, 2048), generator=gen, device="cuda")
    key = jr.key(1, "cuda")
    std = torch.tensor(0.0123, device="cuda")
    cases = {"stacked": lambda v: v.stacked(keys64, 11),
             "unrolled": lambda v: v.unrolled(keys384, 1),
             "sgld": lambda v: v.sgld(leaf, key, std)}
    for name, case in cases.items():
        d = int((case(after) != case(before)).sum())
        report["diff"][name] = d
        print(f"{name}: {d} elements differ from the earlier kernel's")
    bits = torch.arange(1 << 23, dtype=torch.int64, device="cuda") << 9
    nz_ops.LIBRARY = after.lib
    d = int((nz_ops.bits_to_erf_inv_batched(bits)
             != jr.bits_to_erf_inv(bits)).sum())
    report["diff"]["map 2^23"] = d
    print(f"the map on all 2^23 mantissas: {d} differ from the plain map")
    del bits

    turns = [before, after, after, before]
    for name, case in cases.items():
        calls = 5 if name == "sgld" else 20
        times = {v.tag: [] for v in versions}
        for v in turns:
            times[v.tag].append(graph_ms(lambda: case(v), calls))
        report["ms"][name] = times
        print(f"{name}: " + ", ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for tag, ts in times.items()) + f" [{smi}]")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    ok = all(d == 0 for d in report["diff"].values())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
