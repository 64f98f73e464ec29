"""Deterministic synthetic sources: ``batch(step)`` is a pure function of
the step.

The port's copy of ``TokenSource`` and ``RecsysSource`` from
``repro/data/pipeline.py``: numpy only, the same draws batch for batch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenSource", "RecsysSource"]


class TokenSource:
    """Synthetic LM token stream: a noisy deterministic bigram process
    (t+1 = a*t+c mod V with p=0.9)."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 noise: float = 0.1):
        self.batch, self.seq, self.vocab, self.seed = batch, seq, vocab, seed
        self.noise = noise

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq + 1, self.vocab
        toks = np.empty((B, S), dtype=np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        flip = rng.random((B, S)) < self.noise
        rand = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] * 31 + 7) % V
            toks[:, t] = np.where(flip[:, t], rand[:, t], nxt)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class RecsysSource:
    """Synthetic MIND batches: history, profile bags, target + negatives."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg, self.batch, self.seed = cfg, batch, seed

    def __call__(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((self.seed, step))
        return {
            "hist_ids": rng.integers(-1, c.n_items, (self.batch, c.hist_len)).astype(np.int32),
            "profile_ids": rng.integers(
                0, c.profile_vocab,
                (self.batch, c.n_profile_fields, c.profile_bag)).astype(np.int32),
            "target_id": rng.integers(0, c.n_items, self.batch).astype(np.int32),
            "negative_ids": rng.integers(
                0, c.n_items, (self.batch, c.num_sampled_negatives)).astype(np.int32),
        }
