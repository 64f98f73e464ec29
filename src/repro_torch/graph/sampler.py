"""Uniform neighbor sampling (GraphSAGE) over CSR storage.

The port's copy of ``repro/graph/sampler.py``, the same numpy draws in the
same order: fixed-fanout, padded sampled subgraphs of static shape.  The
``minibatch_lg`` shape cell (batch_nodes=1024, fanout 15-10) runs this
two-hop sampler on the host and feeds the batches to the card.

The sampler's generator advances on every call, so a batch depends on
the calls before it, as in the reference (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .storage import CSRGraph

__all__ = ["NeighborSampler", "SampledBlock"]


@dataclass
class SampledBlock:
    """One hop of sampling: for each seed, ``fanout`` neighbor slots.

    ``neighbors`` -- (num_seeds, fanout) int32 global node ids, padded with the
                     seed's own id (self-loop padding keeps aggregation sane).
    ``mask``      -- (num_seeds, fanout) bool, True for real samples.
    """

    seeds: np.ndarray
    neighbors: np.ndarray
    mask: np.ndarray


class NeighborSampler:
    """Uniform without-replacement-ish neighbor sampler over CSR."""

    def __init__(self, graph: CSRGraph, seed: int = 0):
        self.graph = graph
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, seeds: np.ndarray, fanout: int) -> SampledBlock:
        g = self.graph
        seeds = np.asarray(seeds, dtype=np.int64)
        deg = (g.indptr[seeds + 1] - g.indptr[seeds]).astype(np.int64)
        # draw `fanout` uniform positions per seed (with replacement — the
        # standard GraphSAGE estimator); isolated seeds get self-loop padding.
        pos = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(seeds), fanout))
        flat = np.minimum(g.indptr[seeds][:, None] + pos, len(g.adj) - 1)
        nbrs = g.adj[flat].astype(np.int32)
        has_nbrs = deg[:, None] > 0
        nbrs = np.where(has_nbrs, nbrs, seeds[:, None].astype(np.int32))
        mask = np.broadcast_to(has_nbrs, nbrs.shape)
        return SampledBlock(seeds=seeds, neighbors=nbrs, mask=mask)

    def sample_batch(self, batch_nodes: np.ndarray, fanouts: tuple[int, ...]):
        """Multi-hop sampling: returns a list of SampledBlock, innermost last.

        Layer l aggregates from blocks[l]; seeds of hop i are the (flattened)
        neighbors of hop i-1, GraphSAGE-style.
        """
        blocks: list[SampledBlock] = []
        seeds = np.asarray(batch_nodes, dtype=np.int64)
        for f in fanouts:
            blk = self.sample_hop(seeds, f)
            blocks.append(blk)
            seeds = blk.neighbors.reshape(-1).astype(np.int64)
        return blocks
