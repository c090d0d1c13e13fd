"""The port's example scripts run on the CPU: each in a subprocess with
``--device cpu`` and one intra-op thread, exit 0 and its closing check
printed.

  * ``examples/lm_parallel_tempering_torch.py --smoke`` (RE-SGLD, the
    JAX example's smoke preset, one optimizer step a cycle):
    ``multiset ok: True``;
  * ``quickstart_torch.py``, ``multidim_tsu_torch.py``,
    ``async_faults_torch.py`` and ``sharded_ensemble_torch.py`` (one
    process: a one-rank gloo group) each run beside the JAX example it
    ports (``examples/quickstart.py`` etc., ``JAX_PLATFORMS=cpu``, in a
    subprocess at the same time): the two print the same lines, every
    line of the output (acceptance by chunk or cycle, the closing
    ratios, assignments, temperatures and histograms) but the wall
    times, and the port's header counting ranks where JAX's counts
    devices; and each prints the closing checks (the control multiset
    kept, the sharded trace ``run_fused``'s) that ``chip_smoke.py``
    holds the script to on the card, from its ``EXAMPLE_CHECKS``.
"""
import difflib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


# one intra-op thread: the suite runs several workers on the cores
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                     "intra_op_parallelism_threads=1")


def _start(script, *args):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)


def _output(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return out


def _run(script, *args):
    return _output(_start(script, *args))


def test_lm_parallel_tempering_smoke_preset_runs():
    out = _run("lm_parallel_tempering_torch.py", "--smoke", "--device",
               "cpu", "--steps", "1")
    assert "preset=smoke" in out
    assert "multiset ok: True" in out


def _card_checks():
    """``chip_smoke.py``'s closing checks of each example (the one list)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EXAMPLE_CHECKS


_WALL_TIME = re.compile(r"\s+t\s+[\d.]+ ms(/cycle)?$")


def _lines(out):
    """The output without its wall times; the sharded example's header
    names its shards' kind (JAX's devices, the port's ranks)."""
    return [re.sub(r"^ranks: ", "devices: ", _WALL_TIME.sub("", ln))
            for ln in out.splitlines()]


@pytest.mark.parametrize("name", ["async_faults", "multidim_tsu",
                                  "quickstart", "sharded_ensemble"])
def test_md_example_prints_the_jax_examples_lines(name):
    jax_run = _start(f"{name}.py")
    got = _lines(_run(f"{name}_torch.py", "--device", "cpu"))
    want = _lines(_output(jax_run))
    assert got == want, "\n".join(difflib.unified_diff(
        want, got, "JAX", "port", lineterm=""))
    # and the closing checks the card's run of the script holds
    missing = [want for want in _card_checks()[f"{name}_torch.py"]
               if want not in got]
    assert not missing, missing
