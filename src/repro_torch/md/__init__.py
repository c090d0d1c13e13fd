from repro_torch.md.engine import MDEngine  # noqa: F401
