"""Synthetic data pipeline: a numpy copy of ``repro.data.pipeline``, the
same streams for the same seeds.

Offline reproduction of the paper's instruct corpora (Magpie, Evol-Code,
OpenR1-Math...) is impossible; what the PARD *mechanisms* need from data is
(a) learnable sequential structure so target and draft models correlate, and
(b) a deterministic, seedable stream so every experiment is reproducible.

``MarkovCorpus`` generates sequences from a sparse per-token Markov chain with
Zipf-distributed marginals — a standard stand-in for language statistics. A
``prompt/continuation`` split makes it usable for both training and
generation benchmarks. The streaming interface (`batches`) mirrors a real
sharded data loader: infinite iterator, per-host sharding hook, fixed shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class MarkovCorpus:
    vocab_size: int
    branching: int = 4          # out-degree of the transition graph
    zipf_a: float = 1.3
    seed: int = 0
    # transition temperature: lower -> more predictable text
    determinism: float = 0.7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v, b = self.vocab_size, self.branching
        self._succ = rng.integers(0, v, size=(v, b))
        # transition distribution = softmax(z * determinism): higher
        # determinism -> peakier transitions (more predictable "text", the
        # high-acceptance regime of the paper's code/math benchmarks)
        z = rng.normal(size=(v, b))
        ez = np.exp((z - z.max(axis=1, keepdims=True)) * self.determinism)
        self._probs = ez / ez.sum(axis=1, keepdims=True)
        # Zipf marginal for sequence starts
        ranks = np.arange(1, v + 1, dtype=np.float64)
        z = ranks ** (-self.zipf_a)
        self._start = z / z.sum()

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int
               ) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = rng.choice(self.vocab_size, size=batch, p=self._start)
        out[:, 0] = cur
        for t in range(1, seq_len):
            u = rng.random(batch)
            cdf = np.cumsum(self._probs[cur], axis=1)
            choice = (u[:, None] > cdf).sum(axis=1)
            cur = self._succ[cur, choice]
            out[:, t] = cur
        return out

    def batches(self, batch: int, seq_len: int, *, seed: int = 0,
                shard: int = 0, num_shards: int = 1) -> Iterator[np.ndarray]:
        """Infinite deterministic stream; distinct shards get disjoint
        sub-streams (multi-host data parallelism hook)."""
        rng = np.random.default_rng((seed, shard, num_shards))
        while True:
            yield self.sample(rng, batch, seq_len)

    def prompts(self, rng: np.random.Generator, batch: int, prompt_len: int
                ) -> np.ndarray:
        return self.sample(rng, batch, prompt_len)
