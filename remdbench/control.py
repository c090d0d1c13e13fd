"""The control of ``correct``: the reference in bfloat16 put in the
program's place at a cell's own size, judged by the float32 reference as
a run of the program is (``checks.control_readings``).

    python3 remdbench/control.py --workload <cell> --seeds 1,2,3 \
        [--part all|features]

``--part all`` (the default) computes the whole reference in bfloat16;
``--part features`` only the exchange's feature pass, the propagate in
float32.  Prints one JSON line a seed with the numbers the cell
compares; each seed has to fail a limit.  The benchmark's own runs never
run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--part", default="all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from remdbench import checks, harness
    if args.part not in checks.CONTROL_PARTS:
        ap.error(f"--part: one of {checks.CONTROL_PARTS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = checks.control_readings(
            spec["config"], seed, int(spec["traffic"]["chunk_cycles"]),
            args.device, args.part)
        print(json.dumps({"workload": args.workload, "part": args.part,
                          "seed": seed, "numbers": numbers,
                          "fails": not checks.verdict(numbers,
                                                      spec["limits"]),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
