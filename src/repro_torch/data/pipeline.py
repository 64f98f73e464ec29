"""Deterministic synthetic sources, ``batch(step)``, and their bounded
background prefetch.

The port's copy of ``repro/data/pipeline.py``: ``TokenSource``, the GNN
sources (``GNNFullGraphSource``, ``SampledGraphSource``), ``RecsysSource``
and ``Prefetcher``; numpy only, the same draws batch for batch.  Since
every source but ``SampledGraphSource`` is indexable by step, a resumed
run regenerates exactly the batches a crashed one had in flight.
``SampledGraphSource``'s neighbour sampler draws from one generator on
every call, so its batch at a step depends on the calls before it; the
reference's does the same, and the port copies it (ROADMAP Queue 3).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenSource", "GNNFullGraphSource", "SampledGraphSource",
           "RecsysSource", "Prefetcher"]


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


class GNNFullGraphSource:
    """Full-graph batch (same graph every step) with synthetic features.

    ``core_order`` relabels the graph by its degeneracy order
    (:func:`~repro_torch.core.imcore.imcore_peel`, highest core first), the
    paper's ordering as a locality-improving preprocessing step;
    ``pad_nodes`` appends that many zero rows to the node arrays (the
    specs' sink node)."""

    def __init__(self, graph, d_feat: int, num_classes: int, arch: str,
                 seed: int = 0, core_order: bool = False, pad_nodes: int = 0):
        rng = np.random.default_rng(seed)
        if core_order:
            from ..core.imcore import imcore_peel
            order = np.argsort(-imcore_peel(graph), kind="stable")
            perm = np.empty(graph.n, dtype=np.int64)
            perm[order] = np.arange(graph.n)
            graph = graph.relabel(perm)
        self.graph = graph
        src, dst = graph.directed_pairs()
        self.batch = {"src": src.astype(np.int32),
                      "dst": np.asarray(dst, np.int32)}
        n = graph.n
        f32, i32 = np.float32, np.int32
        if arch == "schnet":
            self.batch |= {"z": rng.integers(1, 90, n).astype(i32),
                           "pos": rng.normal(size=(n, 3)).astype(f32),
                           "y": rng.normal(size=n).astype(f32)}
        elif arch == "egnn":
            self.batch |= {"x": rng.normal(size=(n, d_feat)).astype(f32),
                           "pos": rng.normal(size=(n, 3)).astype(f32),
                           "y": rng.normal(size=n).astype(f32)}
        else:
            self.batch |= {"x": rng.normal(size=(n, d_feat)).astype(f32),
                           "labels": rng.integers(0, num_classes,
                                                  n).astype(i32)}
        if pad_nodes:
            for k in ("x", "z", "pos", "y"):
                if k in self.batch:
                    pad = np.zeros((pad_nodes,) + self.batch[k].shape[1:],
                                   self.batch[k].dtype)
                    self.batch[k] = np.concatenate([self.batch[k], pad])

    def __call__(self, step: int) -> dict:
        return self.batch


class SampledGraphSource:
    """minibatch_lg: two-hop neighbour sampling -> flattened subgraph
    ``[seeds | hop 1 | hop 2]``, seeds first, with edges both ways between
    each hop and the one before it."""

    def __init__(self, graph, d_feat: int, num_classes: int, batch_nodes: int,
                 fanout=(15, 10), seed: int = 0):
        from ..graph.sampler import NeighborSampler

        self.graph = graph
        self.sampler = NeighborSampler(graph, seed)
        self.d_feat, self.num_classes = d_feat, num_classes
        self.batch_nodes, self.fanout = batch_nodes, fanout
        rng = np.random.default_rng(seed)
        self.features = rng.normal(size=(graph.n, d_feat)).astype(np.float32)
        self.labels = rng.integers(0, num_classes, graph.n).astype(np.int32)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((17, step))
        seeds = rng.integers(0, self.graph.n, self.batch_nodes)
        blocks = self.sampler.sample_batch(seeds, self.fanout)
        b1, b2 = blocks
        B, f1 = b1.neighbors.shape
        f2 = b2.neighbors.shape[1]
        nodes = np.concatenate(
            [seeds, b1.neighbors.reshape(-1), b2.neighbors.reshape(-1)])
        # local edges: hop1 -> seed, hop2 -> hop1 (both directions)
        h1 = B + np.arange(B * f1)
        h2 = B + B * f1 + np.arange(B * f1 * f2)
        s1 = np.repeat(np.arange(B), f1)
        s2 = np.repeat(h1, f2)
        src = np.concatenate([h1, s1, h2, s2]).astype(np.int32)
        dst = np.concatenate([s1, h1, s2, h2]).astype(np.int32)
        return {
            "x": self.features[nodes],
            "src": src, "dst": dst,
            "labels": self.labels[seeds],
        }


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
