"""Run one cell of the benchmark once and print its result line.

    python3 remdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``remdbench/``
and the program under ``src/``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which standard error repeats as its
last lines).  Exits non-zero, printing no result, without as many CUDA
devices as the cell's ``chips``, when the program cannot be imported,
or when JAX or the JAX package was loaded.  Build caches live inside
the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_env() -> None:
    cache = ROOT / "build" / "remdbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from remdbench import harness
    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"cell {args.workload} needs {chips} CUDA "
                         f"device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    if chips != 1:
        sys.stderr.write(f"cell {args.workload}: this harness runs one-chip "
                         f"cells only\n")
        return 2
    import repro_torch  # noqa: F401  (the program under test)
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write(f"JAX or the JAX package was loaded: {bad}\n")
        return 3
    emit(result)
    return 0


def emit(result) -> None:
    """The result line, last on standard output, and each compared
    number beside its limit, last on standard error."""
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} {c['value']!r} limit "
                         f"{c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)


def _finite(x):
    """JSON has no infinity: a non-finite number is written as its
    name, a string."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
