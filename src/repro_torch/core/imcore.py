"""IMCore: the in-memory core decomposition baseline (Algorithm 1).

The port's own copy of ``repro/core/imcore.py``, the oracle of its tests:

* :func:`imcore_bz` — Batagelj–Zaversnik O(m+n) bin-sort peeling;
* :func:`imcore_peel` — vectorized batch peeling: strips every node of
  degree ≤ k at once.
"""
from __future__ import annotations

import numpy as np

from ..graph.storage import CSRGraph

__all__ = ["imcore_bz", "imcore_peel"]


def imcore_bz(graph: CSRGraph) -> np.ndarray:
    """Batagelj–Zaversnik bin-sort core decomposition. Returns core numbers."""
    n = graph.n
    indptr, adj = graph.indptr, np.asarray(graph.adj)
    deg = np.diff(indptr).astype(np.int64)
    md = int(deg.max()) if n else 0
    counts = np.bincount(deg, minlength=md + 1)
    bin_start = np.concatenate([[0], np.cumsum(counts)])[:-1].copy()
    vert = np.argsort(deg, kind="stable").astype(np.int64)
    pos = np.empty(n, dtype=np.int64)
    pos[vert] = np.arange(n)
    deg = deg.copy()
    core = np.zeros(n, dtype=np.int64)
    for i in range(n):
        v = vert[i]
        core[v] = deg[v]
        for u in adj[indptr[v]: indptr[v + 1]]:
            if deg[u] > deg[v]:
                du, pu = deg[u], pos[u]
                pw = bin_start[du]
                w = vert[pw]
                if u != w:  # swap u to the front of its bin
                    pos[u], pos[w] = pw, pu
                    vert[pu], vert[pw] = w, u
                bin_start[du] += 1
                deg[u] -= 1
    return core


def imcore_peel(graph: CSRGraph) -> np.ndarray:
    """Vectorized exact peeling: strip all nodes with degree ≤ k per round."""
    n = graph.n
    src, dst = graph.directed_pairs()
    src = src.astype(np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    deg = graph.degrees().copy()
    core = np.zeros(n, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    remaining = n
    k = 0
    while remaining:
        k = max(k, int(deg[alive].min()))
        while True:
            f = alive & (deg <= k)
            if not f.any():
                break
            core[f] = k
            alive[f] = False
            remaining -= int(f.sum())
            emask = f[src]
            if emask.any():
                deg -= np.bincount(dst[emask], minlength=n)
                keep = ~emask & alive[src] & alive[dst]
                src, dst = src[keep], dst[keep]
        if remaining and len(src) == 0:
            core[alive] = k  # all remaining nodes are isolated at level k
            break
    return core
