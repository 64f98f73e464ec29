"""Synthetic graph generators standing in for the paper's datasets (Table I).

The port's own copy of ``repro/graph/generators.py``, same draws for the
same seed:

  * ``chung_lu``    -- power-law expected-degree graphs (social-network-like);
  * ``rmat``        -- Kronecker/R-MAT graphs (web-crawl-like skew);
  * ``erdos_renyi`` -- uniform random (control / tests);
  * ``ba``          -- Barabási–Albert preferential attachment;
  * ``powerlaw_chunks`` -- Chung-Lu edges streamed as ``(k, 2)`` chunks,
    O(chunk) memory per draw, for graphs of tens of millions of edges;
  * ``rmat_chunks`` / ``uniform_chunks`` -- the R-MAT and uniform regimes
    streamed the same way.  The streams feed the external-memory builder
    (:func:`repro_torch.graph.build.build_csr`).
"""
from __future__ import annotations

import numpy as np

from .storage import CSRGraph

__all__ = [
    "chung_lu", "rmat", "erdos_renyi", "ba", "DATASET_SUITE", "make_dataset",
    "rmat_chunks", "powerlaw_chunks", "uniform_chunks",
]


def erdos_renyi(n: int, m: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m * 1.15) + 8, 2), dtype=np.int64)
    return CSRGraph.from_edges(n, e[: m * 2])


def chung_lu(n: int, m: int, gamma: float = 2.5, seed: int = 0) -> CSRGraph:
    """Power-law expected-degree model: w_i ∝ (i + i0)^(-1/(gamma-1))."""
    rng = np.random.default_rng(seed)
    i0 = n ** (1.0 / (gamma - 1.0)) / 10.0 + 1.0
    w = (np.arange(n) + i0) ** (-1.0 / (gamma - 1.0))
    p = w / w.sum()
    draws = int(m * 1.3) + 16  # dedup shrinks the count back toward m
    src = rng.choice(n, size=draws, p=p)
    dst = rng.choice(n, size=draws, p=p)
    perm = rng.permutation(n)  # node id does not correlate with degree
    e = np.stack([perm[src], perm[dst]], axis=1)
    return CSRGraph.from_edges(n, e)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0) -> CSRGraph:
    """R-MAT / Kronecker generator (web-graph-like skew), n = 2**scale."""
    n = 1 << scale
    m = n * edge_factor
    e = np.concatenate(
        list(rmat_chunks(scale, edge_factor, a, b, c, seed, chunk_edges=m)))
    return CSRGraph.from_edges(n, e)


def ba(n: int, attach: int = 4, seed: int = 0) -> CSRGraph:
    """Barabási–Albert via the repeated-nodes trick."""
    rng = np.random.default_rng(seed)
    targets = list(range(attach))
    repeated: list[int] = []
    edges = []
    for v in range(attach, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * attach)
        idx = rng.integers(0, len(repeated), size=attach)
        targets = [repeated[i] for i in idx]
    return CSRGraph.from_edges(n, np.array(edges, dtype=np.int64))


def rmat_chunks(scale: int, edge_factor: int = 16, a: float = 0.57,
                b: float = 0.19, c: float = 0.19, seed: int = 0,
                chunk_edges: int = 1 << 20):
    """Stream R-MAT edges (n = 2**scale, ~n * edge_factor raw draws)."""
    m = (1 << scale) * edge_factor
    rng = np.random.default_rng(seed)
    for lo in range(0, m, chunk_edges):
        k = min(chunk_edges, m - lo)
        src = np.zeros(k, dtype=np.int64)
        dst = np.zeros(k, dtype=np.int64)
        for bit in range(scale):
            r1 = rng.random(k)
            r2 = rng.random(k)
            src_bit = r1 > (a + b)
            ab = np.where(src_bit, c / (c + (1 - a - b - c)), a / (a + b))
            dst_bit = r2 > ab
            src |= src_bit.astype(np.int64) << bit
            dst |= dst_bit.astype(np.int64) << bit
        yield np.stack([src, dst], axis=1)


def powerlaw_chunks(n: int, m: int, gamma: float = 2.5, seed: int = 0,
                    chunk_edges: int = 1 << 20):
    """Stream Chung-Lu power-law edges: endpoints ~ w_i ∝ (i + i0)^(-1/(γ-1)),
    drawn by inverse-transform sampling over the exact weight cumsum.
    Duplicates and self loops are left to ``CSRGraph.from_edges``."""
    rng = np.random.default_rng(seed)
    i0 = n ** (1.0 / (gamma - 1.0)) / 10.0 + 1.0
    w = (np.arange(n) + i0) ** (-1.0 / (gamma - 1.0))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    perm = rng.permutation(n)  # decorrelate id and degree

    def draw(k):
        # searching sorted keys walks the cdf in order instead of missing
        # the cache on every probe; the indices are the same
        u = rng.random(k)
        order = np.argsort(u)
        idx = np.empty(k, dtype=np.int64)
        idx[order] = np.searchsorted(cdf, u[order], side="left")
        return idx

    for lo in range(0, m, chunk_edges):
        k = min(chunk_edges, m - lo)
        src = draw(k)
        dst = draw(k)
        yield np.stack([perm[src], perm[dst]], axis=1).astype(np.int64)


def uniform_chunks(n: int, m: int, seed: int = 0, chunk_edges: int = 1 << 20):
    """Stream uniform (Erdős–Rényi-style) endpoint pairs."""
    rng = np.random.default_rng(seed)
    for lo in range(0, m, chunk_edges):
        k = min(chunk_edges, m - lo)
        yield rng.integers(0, n, size=(k, 2), dtype=np.int64)


# A scaled-down stand-in for Table I: name -> (generator, kwargs), spanning
# the paper's density regimes (m/n from 2.1 [WIKI] to 43.5 [Clueweb]).
DATASET_SUITE: dict[str, tuple] = {
    "dblp-sim":    ("chung_lu", dict(n=30_000, m=100_000, gamma=2.3)),
    "youtube-sim": ("chung_lu", dict(n=60_000, m=160_000, gamma=2.2)),
    "wiki-sim":    ("chung_lu", dict(n=100_000, m=210_000, gamma=2.1)),
    "cpt-sim":     ("erdos_renyi", dict(n=80_000, m=350_000)),
    "lj-sim":      ("chung_lu", dict(n=100_000, m=870_000, gamma=2.5)),
    "orkut-sim":   ("chung_lu", dict(n=60_000, m=2_300_000, gamma=2.8)),
    "webbase-sim": ("rmat", dict(scale=16, edge_factor=9)),
    "twitter-sim": ("rmat", dict(scale=15, edge_factor=36)),
    "uk-sim":      ("rmat", dict(scale=16, edge_factor=35)),
}

_GENERATORS = {"chung_lu": chung_lu, "erdos_renyi": erdos_renyi,
               "rmat": rmat, "ba": ba}


def make_dataset(name: str, seed: int = 0) -> CSRGraph:
    gen, kwargs = DATASET_SUITE[name]
    return _GENERATORS[gen](seed=seed, **kwargs)
