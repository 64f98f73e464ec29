"""Seeded kernel inputs for checking the kernels against their plain
versions and against the reference implementation.

``CASES`` are the block-boundary shapes of the reference kernel's own
tests — ``(n, m, tile_edges, isolated_fraction, frontier)``: multi-block,
one partial tail block, odd n, isolated nodes, empty/all/random frontiers.
``tile_edges`` only matters to the reference's blocked kernel.
:func:`superstep_case` draws an undirected multigraph of that shape (every
edge in both endpoint lists, the contract of the port's push pass) and the
node state of one superstep, from numpy's generator alone.

The segment sums are checked over ``SEGSUM_DTYPES`` x ``SEGSUM_WIDTHS`` x
``SEGSUM_BLOCKS`` x ``SEGSUM_FRONTIERS``: :func:`segsum_rows` draws sorted
rows with rows longer than a block, empty rows and an edge count that
leaves a partial last block, :func:`segsum_values` the values and
:func:`segsum_frontier` the active rows; ``SEGSUM_TOL`` holds the
tolerances (rtol, atol) of the reference's kernel tests.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CASES", "superstep_case", "SEGSUM_DTYPES", "SEGSUM_WIDTHS",
           "SEGSUM_BLOCKS", "SEGSUM_FRONTIERS", "SEGSUM_TOL", "segsum_rows",
           "segsum_values", "segsum_frontier"]

SEGSUM_DTYPES = ("float32", "bfloat16", "int32")
SEGSUM_WIDTHS = (1, 8, 128)
SEGSUM_BLOCKS = (64, 128, 512)
SEGSUM_FRONTIERS = ("all", "none", "sparse", "prefix")
#: (rtol, atol): int32 exact; both sides sum floats in float32, in another
#: order (atomics on the card)
SEGSUM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-1),
              "int32": (0, 0)}

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


def segsum_rows(rng: np.random.Generator, n: int, E: int) -> np.ndarray:
    """(<= E,) int32 sorted rows over ``n`` segments: mostly short rows, a
    fifth of them empty, three of 150-400 edges (longer than any block);
    cut at E, which leaves a partial last block for E not a multiple of the
    block size."""
    lens = rng.integers(0, 6, size=n)
    lens[rng.choice(n, size=3, replace=False)] = rng.integers(150, 400, 3)
    lens[rng.choice(n, size=n // 5, replace=False)] = 0
    return np.repeat(np.arange(n, dtype=np.int32), lens)[:E]


def segsum_values(rng: np.random.Generator, E: int, D: int,
                  dtype: str) -> np.ndarray:
    """(E,) for D == 1, else (E, D): small integers for int32, normal
    floats (float32, cast by the caller) otherwise."""
    shape = (E,) if D == 1 else (E, D)
    if dtype == "int32":
        return rng.integers(-5, 6, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def segsum_frontier(kind: str, rng: np.random.Generator,
                    n: int) -> np.ndarray:
    """Active rows: all, none, a sparse random 5%, or a contiguous prefix
    of a quarter."""
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "sparse":
        return rng.random(n) < 0.05
    if kind == "prefix":
        return np.arange(n) < n // 4
    raise ValueError(f"unknown frontier {kind!r}")
