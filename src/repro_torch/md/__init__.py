from repro_torch.md.engine import HarmonicEngine, LJEngine, MDEngine  # noqa: F401
from repro_torch.md.system import MolecularSystem, chain_molecule  # noqa: F401
