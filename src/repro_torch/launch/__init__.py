"""Launchers: ``serve`` (prefill a batch of prompts, decode greedily),
``repex_run`` (the RepEx command line) and ``mesh`` (the replica meshes
of ``run_sharded``)."""
