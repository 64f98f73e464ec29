"""The seeded graph families and storage backings of the differential sweep.

The reference's sweep (``tests/test_differential.py``) draws its seven
graph families and its three backings in a test module that imports the
JAX package; this is the port's copy of both, so a sweep can run where
JAX is absent (the card).  The graphs are the reference's, edge for edge:

* ``erdos_renyi`` — G(n=200, m=700), seed 7;
* ``powerlaw`` — Chung-Lu (n=250, 900 edges, gamma 2.3), seed 11;
* ``star`` — one hub and 40 leaves;
* ``clique`` — K13;
* ``disconnected`` — a K6 and a K4, joined by nothing;
* ``isolated`` — a path over ids with gaps (nodes 0, 5, 9 edgeless);
* ``empty`` — 7 nodes, no edges.

Backings (:func:`with_backing`): ``inmem`` (the generator's CSR),
``memmap`` (saved and reopened with ``np.memmap``: the out-of-core edge
table) and ``buffered`` (a ``BufferedGraph`` whose base differs from the
graph — edges held out, decoys present — and whose update buffer patches
it back, so merged neighbour reads are what the engine consumes).
"""
from __future__ import annotations

import os

import numpy as np

from .generators import chung_lu, erdos_renyi
from .storage import CSRGraph
from .updates import BufferedGraph

__all__ = ["ALGORITHMS", "BACKINGS", "FAMILIES", "buffered_backing",
           "with_backing"]

ALGORITHMS = ("semicore", "semicore+", "semicore*")
BACKINGS = ("inmem", "memmap", "buffered")


def _star(n: int = 41) -> CSRGraph:
    e = np.stack([np.zeros(n - 1, np.int64),
                  np.arange(1, n, dtype=np.int64)], 1)
    return CSRGraph.from_edges(n, e)


def _clique(n: int = 13) -> CSRGraph:
    ij = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                  np.int64)
    return CSRGraph.from_edges(n, ij)


def _disconnected() -> CSRGraph:
    """Two cliques of different core number joined by nothing."""
    a = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)],
                 np.int64)
    b = 6 + np.array([(i, j) for i in range(4) for j in range(i + 1, 4)],
                     np.int64)
    return CSRGraph.from_edges(10, np.concatenate([a, b]))


def _isolated() -> CSRGraph:
    """A path embedded in a larger id space: nodes 0, 5, 9 have no edges."""
    e = np.array([(1, 2), (2, 3), (3, 4), (4, 6), (6, 7), (7, 8)], np.int64)
    return CSRGraph.from_edges(10, e)


def _empty() -> CSRGraph:
    return CSRGraph.from_edges(7, np.zeros((0, 2), np.int64))


FAMILIES = {
    "erdos_renyi": lambda: erdos_renyi(200, 700, seed=7),
    "powerlaw": lambda: chung_lu(250, 900, gamma=2.3, seed=11),
    "star": _star,
    "clique": _clique,
    "disconnected": _disconnected,
    "isolated": _isolated,
    "empty": _empty,
}


def buffered_backing(g: CSRGraph) -> BufferedGraph:
    """A BufferedGraph whose merged view equals ``g`` but whose base does
    not: ~30% of the edges held out and re-inserted through the buffer, up
    to 5 decoy edges present in the base and deleted through it (the
    reference's draw, seeded by the graph's size)."""
    e = g.edge_list()
    rng = np.random.default_rng(g.n * 1000 + g.m)
    hold_out = rng.random(len(e)) < 0.3 if len(e) else np.zeros(0, bool)
    base_edges = e[~hold_out]
    present = set(map(tuple, e))
    decoys = []
    for _ in range(200):
        u, v = int(rng.integers(g.n)), int(rng.integers(g.n))
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key not in present and key not in decoys:
            decoys.append(key)
        if len(decoys) >= 5:
            break
    if decoys:
        base_edges = np.concatenate([base_edges, np.array(decoys, np.int64)])
    bg = BufferedGraph(CSRGraph.from_edges(g.n, base_edges),
                       buffer_capacity=1 << 30)
    for u, v in decoys:
        if not bg.delete_edge(int(u), int(v)):
            raise AssertionError(f"decoy ({u}, {v}) was not in the base")
    for u, v in e[hold_out]:
        if not bg.insert_edge(int(u), int(v)):
            raise AssertionError(f"held-out ({u}, {v}) was in the base")
    return bg


def with_backing(g: CSRGraph, backing: str, tmpdir: str):
    """``g`` on one of :data:`BACKINGS`; ``memmap`` saves under
    ``tmpdir``."""
    if backing == "inmem":
        return g
    if backing == "memmap":
        path = os.path.join(tmpdir, "g")
        g.save(path)
        return CSRGraph.load(path, mmap=True)
    if backing == "buffered":
        if g.n == 0:
            return BufferedGraph(g)
        return buffered_backing(g)
    raise ValueError(f"unknown backing {backing!r}")
