"""Launchers: ``serve`` (prefill a batch of prompts, decode greedily)."""
