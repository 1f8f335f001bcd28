"""Deterministic sharded synthetic LM token pipeline, a numpy copy of
``repro/data/tokens.py`` that gives its batches exactly.

Production-shaped: each host generates only its shard of the global batch
(deterministic in (seed, step, shard)), so restarts and elastic re-sharding
reproduce the exact global stream — the property a real distributed loader
must have for fault-tolerant training (checkpoint stores only (seed, step)).

The synthetic stream is a order-2 Markov chain over the vocab with
arch-dependent transition structure, giving a learnable (non-uniform) target
so example training runs show decreasing loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenPipeline"]


@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide into n_shards")
        self.local_batch = self.global_batch // self.n_shards
        # small structured transition table: token t -> base + (t*a + c) % m
        rng = np.random.default_rng(self.seed)
        self._mult = int(rng.integers(3, 64) * 2 + 1)
        self._add = int(rng.integers(1, self.vocab))
        self._noise = 0.15

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.shard)

    def batch(self, step: int) -> dict:
        """{"tokens": (local_batch, S) int32, "labels": ...} for one step."""
        rng = self._rng(step)
        B, S, V = self.local_batch, self.seq_len, self.vocab
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < self._noise
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * self._mult + self._add) % V
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def skip_to(self, step: int) -> "TokenPipeline":
        """No-op by construction (stateless in step) — documents the contract."""
        return self
