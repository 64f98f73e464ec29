"""Deterministic synthetic sources: ``batch(step)`` is a pure function of
the step; and their bounded background prefetch.

The port's copy of ``TokenSource``, ``RecsysSource`` and ``Prefetcher``
from ``repro/data/pipeline.py``: numpy only, the same draws batch for
batch.  Since every source is indexable by step, a resumed run regenerates
exactly the batches a crashed one had in flight.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenSource", "RecsysSource", "Prefetcher"]


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


class Prefetcher:
    """Bounded background prefetch of step-indexed batches: a daemon
    thread calls ``source(step)`` for ``start_step``, ``start_step + 1``,
    ... and keeps at most ``depth`` batches ahead; ``next()`` gives
    ``(step, batch)`` in step order; :meth:`close` stops the thread and
    waits for it (its current ``source`` call, then 0.1 s at most)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join()
