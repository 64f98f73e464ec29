"""Seeded superstep inputs for checking the kernels against their plain
versions and against the reference implementation.

``CASES`` are the block-boundary shapes of the reference kernel's own
tests — ``(n, m, tile_edges, isolated_fraction, frontier)``: multi-block,
one partial tail block, odd n, isolated nodes, empty/all/random frontiers.
``tile_edges`` only matters to the reference's blocked kernel.
:func:`superstep_case` draws an undirected multigraph of that shape (every
edge in both endpoint lists, the contract of the port's push pass) and the
node state of one superstep, from numpy's generator alone.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CASES", "superstep_case"]

CASES = [
    (50, 200, 16, 0.0, "all"),
    (50, 200, 16, 0.0, "rand"),
    (50, 200, 16, 0.0, "empty"),
    (40, 60, 512, 0.0, "rand"),       # one partial tail block
    (33, 130, 16, 0.3, "rand"),       # isolated nodes, odd n
    (7, 9, 8, 0.0, "all"),            # tiny
]


def superstep_case(n: int, m: int, iso_frac: float, frontier: str,
                   rng: np.random.Generator) -> dict:
    """A symmetric random multigraph CSR plus superstep state, as numpy:
    ``seg_ptr`` int64 (n+1,), ``nbr``/``rows``/``core``/``cnt``/``thr``
    int32, ``active`` bool; ``thr`` are count thresholds for the frontier."""
    live = np.flatnonzero(rng.random(n) >= iso_frac)
    if len(live) >= 2:
        src = rng.choice(live, size=m)
        dst = rng.choice(live, size=m)
        keep = src != dst
        src, dst = src[keep], dst[keep]
    else:
        src = dst = np.zeros(0, dtype=np.int64)
    rows = np.concatenate([src, dst])
    nbr = np.concatenate([dst, src])
    order = np.lexsort((nbr, rows))
    rows, nbr = rows[order].astype(np.int32), nbr[order].astype(np.int32)
    deg = np.bincount(rows, minlength=n)
    seg_ptr = np.zeros(n + 1, dtype=np.int64)
    seg_ptr[1:] = np.cumsum(deg)
    core = np.minimum(deg, rng.integers(0, 12, size=n))
    core = np.where(deg > 0, np.maximum(core, 1), 0).astype(np.int32)
    cnt = rng.integers(0, 8, size=n).astype(np.int32)
    if frontier == "empty":
        active = np.zeros(n, dtype=bool)
    elif frontier == "all":
        active = core > 0
    else:
        active = (core > 0) & (rng.random(n) < 0.4)
    cmax = int(core[active].max()) if active.any() else 0
    thr = np.where(active, rng.integers(0, cmax + 1, size=n), 0)
    return dict(seg_ptr=seg_ptr, nbr=nbr, rows=rows, core=core, cnt=cnt,
                active=active, thr=thr.astype(np.int32))
