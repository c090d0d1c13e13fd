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
print(" ".join(names))
"""

# the modules of the driver's fault-tolerance slice (patterns, modes,
# failures, the checkpoint package and the driver around them), of the
# observability slice (telemetry, the report, the repex_run CLI), of
# the replica-sharded slice (sharding, the mesh, the exchange) and of the
# LM training slice (data, optimizers, the RE-SGLD engine, the train step
# and launcher)
SLICE_MODULES = ("repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
                 "repro_torch.core.patterns", "repro_torch.core.modes",
                 "repro_torch.core.failures", "repro_torch.core.repex",
                 "repro_torch.md.engine", "repro_torch.md.energy",
                 "repro_torch.obs", "repro_torch.obs.telemetry",
                 "repro_torch.obs.report", "repro_torch.launch.repex_run",
                 "repro_torch.md.neighbors",
                 "repro_torch.kernels.nlist_build.ops",
                 "repro_torch.sharding", "repro_torch.launch.mesh",
                 "repro_torch.core.exchange",
                 "repro_torch.data", "repro_torch.data.synthetic",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.sgld", "repro_torch.optim.compression",
                 "repro_torch.models.lm_engine", "repro_torch.launch.steps",
                 "repro_torch.launch.train")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_repro():
    code = _PROBE.format(src=str(ROOT / "src"),
                         smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20                  # every module of the port
    missing = [m for m in SLICE_MODULES if m not in names]
    assert not missing, f"not imported without jax: {missing}"


def test_no_source_names_jax_or_repro():
    assert len(_sources()) > 17
    assert PORT / "ckpt" / "checkpoint.py" in _sources()
    for path in _sources():
        hits = IMPORT_RE.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"


def test_regex_tells_repro_from_repro_torch():
    assert IMPORT_RE.search("from repro.core import x")
    assert IMPORT_RE.search("    import jax.numpy as jnp")
    assert not IMPORT_RE.search("from repro_torch.core import x")
    assert not IMPORT_RE.search("import jaxtyping")
