"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package (``repro``), not even its
JAX-free modules."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.MULTILINE)

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_repro():
    code = _PROBE.format(src=str(ROOT / "src"),
                         smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 17     # every module of the slice


def test_no_source_names_jax_or_repro():
    assert len(_sources()) > 17
    for path in _sources():
        hits = IMPORT_RE.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"


def test_regex_tells_repro_from_repro_torch():
    assert IMPORT_RE.search("from repro.core import x")
    assert IMPORT_RE.search("    import jax.numpy as jnp")
    assert not IMPORT_RE.search("from repro_torch.core import x")
    assert not IMPORT_RE.search("import jaxtyping")
