"""Deterministic synthetic token pipeline: the port's copy of the JAX
package's ``repro/data/synthetic.py`` (numpy only, so its batches are
bitwise the JAX package's).

A Zipf-weighted Markov chain over the vocabulary: learnable structure
(bigram statistics a model can fit, so loss decreases measurably) with a
procedural, seed-deterministic generator; no datasets are shipped.
Batches are produced per host with disjoint seed streams (``host_id``,
``n_hosts``); on one host it degenerates to plain arrays.  Callers move
a batch to their device with ``torch.as_tensor``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def zipf_markov_stream(vocab_size: int, seed: int, branching: int = 32,
                       alpha: float = 1.3):
    """Build deterministic bigram structure: each token has `branching`
    plausible successors with Zipf weights."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    weights = 1.0 / np.arange(1, branching + 1) ** alpha
    weights = weights / weights.sum()
    return succ, weights


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        self.succ, self.weights = zipf_markov_stream(self.vocab_size,
                                                     self.seed)
        self._rng = np.random.default_rng(
            (self.seed * 1009 + self.host_id) & 0x7FFFFFFF)
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        self.host_batch = self.global_batch // self.n_hosts

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, s = self.host_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self._rng.integers(0, self.vocab_size, size=b)
        choices = self._rng.choice(self.succ.shape[1], size=(b, s),
                                   p=self.weights)
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
