"""The port's example scripts run on the CPU: each in a subprocess at a
cut size, exit 0 and its closing check printed.

  * ``examples/lm_parallel_tempering_torch.py --smoke`` (RE-SGLD, the
    JAX example's smoke preset, one optimizer step a cycle):
    ``multiset ok: True``.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_lm_parallel_tempering_smoke_preset_runs():
    # one intra-op thread: the suite runs several workers on the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "lm_parallel_tempering_torch.py"),
         "--smoke", "--device", "cpu", "--steps", "1"],
        capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr
    assert "preset=smoke" in out.stdout
    assert "multiset ok: True" in out.stdout
