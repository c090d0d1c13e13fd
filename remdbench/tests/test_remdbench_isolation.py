"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (whole names: the program's
``repro_torch`` begins with ``repro``), and a reference that loads
nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "remdbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _loaded(
        "import remdbench.run, remdbench.harness, remdbench.checks\n"
        "import glob, importlib.util\n"
        "for p in sorted(glob.glob('remdbench/metrics/*.py')):\n"
        "    s = importlib.util.spec_from_file_location('m', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "import repro_torch.core, repro_torch.md, repro_torch.obs\n")
    assert "repro_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = ", ".join(f"remdbench.reference.{p.stem}"
                     for p in sorted((BENCH / "reference").glob("*.py"))
                     if p.stem != "__init__")
    names = _loaded(f"import {mods}, remdbench.checks, "
                    "remdbench.counts.chain")
    assert not names & (set(FORBIDDEN) | {"repro_torch"})


def test_reference_of_every_cell_loads_nothing_of_the_program():
    """The reference each cell's configuration selects, built and run on
    a tiny system."""
    names = _loaded(
        "import sys, json, torch\n"
        "sys.path.insert(0, 'remdbench/tests')\n"
        "from remdbench import checks\n"
        "from remdbench_tiny import tiny_spec\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    spec = tiny_spec(w['name'])\n"
        "    ref = checks.reference(spec['config'], 'cpu')\n"
        "    ref.model.features(ref.model.init_state(1)[0])\n")
    assert "remdbench" in names
    assert not names & (set(FORBIDDEN) | {"repro_torch"})


def test_reference_sources_import_no_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module] if node.level == 0 else []
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN + ("repro_torch",), \
                    (path.name, m)
