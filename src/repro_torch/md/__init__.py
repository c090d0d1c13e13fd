from repro_torch.md.engine import HarmonicEngine, LJEngine, MDEngine  # noqa: F401
