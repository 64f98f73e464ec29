"""Seeded kernel inputs for checking the kernels against their plain
versions and against the reference implementation.

``CASES`` are the block-boundary shapes of the reference kernel's own
tests — ``(n, m, tile_edges, isolated_fraction, frontier)``: multi-block,
one partial tail block, odd n, isolated nodes, empty/all/random frontiers.
``tile_edges`` only matters to the reference's blocked kernel.
:func:`superstep_case` draws an undirected multigraph of that shape (every
edge in both endpoint lists, the contract of the port's push pass) and the
node state of one superstep, from numpy's generator alone.

The fused superstep kernels' degree bins are checked on
:func:`binned_case` (a row at every degree of ``BIN_DEGREES``: each
boundary of ``fused_superstep.degree_bin`` -1, at and +1, and 0) and
:func:`star_case` (a hub of ``STAR_LEAVES`` leaves, whose cap outgrows
the shared histogram), with node state from :func:`superstep_state` over
the frontiers of ``STATE_FRONTIERS``.

The segment sums are checked over ``SEGSUM_DTYPES`` x ``SEGSUM_WIDTHS`` x
``SEGSUM_BLOCKS`` x ``SEGSUM_FRONTIERS``: :func:`segsum_rows` draws sorted
rows with rows longer than a block, empty rows and an edge count that
leaves a partial last block, :func:`segsum_values` the values and
:func:`segsum_frontier` the active rows; ``SEGSUM_TOL`` holds the
tolerances (rtol, atol) of the reference's kernel tests.

The embedding bag is checked over ``BAG_CASES`` (the reference's sweep,
``(N, D, B, L)``) x ``BAG_MODES`` x ``BAG_DTYPES``, with and without
weights (:func:`bag_case`: a quarter of the slots masked); the flash decode
over ``DECODE_CASES`` (the reference's sweep, ``(Hkv, G, S, d)``, then
the served head groups of Qwen3-14B, G = 5, and of Yi-34B and Arctic,
G = 7, at d = 128; batched over ``DECODE_BATCH`` rows at the model layout) x ``DECODE_DTYPES`` x
:func:`decode_lens` (:func:`decode_case`), the lengths at the boundaries
of the kernel's split rule.  ``BAG_TOL`` and ``DECODE_TOL``
hold (rtol, atol) of kernel against plain version.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CASES", "superstep_case", "BIN_DEGREES", "STAR_LEAVES",
           "STATE_FRONTIERS", "binned_case", "star_case", "superstep_state", "SEGSUM_DTYPES", "SEGSUM_WIDTHS",
           "SEGSUM_BLOCKS", "SEGSUM_FRONTIERS", "SEGSUM_TOL", "segsum_rows",
           "segsum_values", "segsum_frontier", "BAG_CASES", "BAG_MODES",
           "BAG_DTYPES", "BAG_TOL", "bag_case", "DECODE_CASES",
           "DECODE_BATCH", "DECODE_DTYPES", "DECODE_TOL", "decode_lens",
           "decode_case"]

SEGSUM_DTYPES = ("float32", "bfloat16", "int32")
SEGSUM_WIDTHS = (1, 8, 128)
SEGSUM_BLOCKS = (64, 128, 512)
SEGSUM_FRONTIERS = ("all", "none", "sparse", "prefix")
#: (rtol, atol): int32 exact; both sides sum floats in float32, in another
#: order (atomics on the card)
SEGSUM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-1),
              "int32": (0, 0)}

#: the reference's sweep, then MIND's own bags (1,000 rows of 64, 16
#: slots), more slots than one warp has lanes (L = 37), and a width of 20
#: (no whole bfloat16 16-byte word)
BAG_CASES = ((100, 16, 4, 3), (1000, 64, 8, 10), (37, 128, 16, 5),
             (10, 8, 1, 1), (1000, 64, 64, 16), (300, 64, 9, 37),
             (50, 20, 6, 7))
BAG_MODES = ("sum", "mean")
BAG_DTYPES = ("float32", "bfloat16")
#: (rtol, atol): both sides sum in float32 in another order and round once;
#: a bfloat16 result may land one bfloat16 step (2**-8 relative) apart
BAG_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}

DECODE_CASES = ((2, 4, 1024, 64), (8, 1, 512, 128), (1, 8, 2048, 64),
                (4, 7, 512, 32), (8, 5, 512, 128), (8, 7, 512, 128))
DECODE_BATCH = 2
DECODE_DTYPES = ("float32", "bfloat16")
#: (rtol, atol): float32 at the reference's kernel tolerance; a bfloat16
#: output may land one bfloat16 step apart after the same float32 softmax
DECODE_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-2)}

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


#: a row of each degree: fused_superstep's bin boundaries (33, 513, 8192)
#: -1, at and +1, the bins' edges (1, 32, 512, 8191) and 0
BIN_DEGREES = (0, 1, 2, 31, 32, 33, 34, 511, 512, 513, 514, 8190, 8191,
               8192, 8193)
STAR_LEAVES = 100_000
#: frontiers of :func:`superstep_state`: no row, one row (the largest
#: degree), every row, a random 40%
STATE_FRONTIERS = ("none", "one", "all", "rand")


def _symmetric(n: int, src: np.ndarray, dst: np.ndarray) -> tuple:
    """(seg_ptr int64, nbr int32) of the undirected multigraph with these
    edges, each in both endpoint lists, rows sorted."""
    rows = np.concatenate([src, dst]).astype(np.int64)
    nbr = np.concatenate([dst, src]).astype(np.int64)
    order = np.lexsort((nbr, rows))
    deg = np.bincount(rows, minlength=n)
    seg_ptr = np.zeros(n + 1, dtype=np.int64)
    seg_ptr[1:] = np.cumsum(deg)
    return seg_ptr, nbr[order].astype(np.int32)


def binned_case(rng: np.random.Generator, pool: int = 2000) -> dict:
    """``seg_ptr``/``nbr`` (as :func:`superstep_case`) of a graph with one
    hub row of each degree in ``BIN_DEGREES``, whose edges go to a pool of
    ``pool`` nodes that also share random edges among themselves (their
    degrees fill the small bins)."""
    hubs = len(BIN_DEGREES)
    n = hubs + pool
    src = [np.full(d, h) for h, d in enumerate(BIN_DEGREES)]
    dst = [hubs + rng.integers(0, pool, size=d) for d in BIN_DEGREES]
    ps = hubs + rng.integers(0, pool, size=6 * pool)
    pd = hubs + rng.integers(0, pool, size=6 * pool)
    keep = ps != pd
    seg_ptr, nbr = _symmetric(n, np.concatenate(src + [ps[keep]]),
                              np.concatenate(dst + [pd[keep]]))
    return dict(seg_ptr=seg_ptr, nbr=nbr)


def star_case(rng: np.random.Generator, leaves: int = STAR_LEAVES) -> dict:
    """A hub (row 0) with ``leaves`` leaves, each leaf also joined to one
    random other leaf."""
    n = leaves + 1
    a = rng.integers(1, n, size=leaves)
    b = rng.integers(1, n, size=leaves)
    keep = a != b
    seg_ptr, nbr = _symmetric(n, np.concatenate([np.zeros(leaves, np.int64),
                                                 a[keep]]),
                              np.concatenate([np.arange(1, n), b[keep]]))
    return dict(seg_ptr=seg_ptr, nbr=nbr)


def superstep_state(seg_ptr: np.ndarray, frontier: str, cores: str,
                    rng: np.random.Generator) -> dict:
    """Node state of one superstep on a table: ``core`` the degrees
    (``cores="degree"``, the first pass) or uniform in [0, 2 x degree]
    (``"random"``: caps below and at the degree), ``cnt`` uniform in [0,
    8), ``active`` by ``frontier`` (``STATE_FRONTIERS``; "one" is the
    row of largest degree), ``thr`` count thresholds in [0, core]."""
    deg = np.diff(seg_ptr)
    n = len(deg)
    if cores == "degree":
        core = deg.copy()
    else:
        core = rng.integers(0, 2 * deg + 1)
    if frontier == "none":
        active = np.zeros(n, dtype=bool)
    elif frontier == "one":
        active = np.zeros(n, dtype=bool)
        active[int(np.argmax(deg))] = True
    elif frontier == "all":
        active = np.ones(n, dtype=bool)
    else:
        active = rng.random(n) < 0.4
    return dict(core=core.astype(np.int32),
                cnt=rng.integers(0, 8, size=n).astype(np.int32),
                active=active,
                thr=rng.integers(0, core + 1).astype(np.int32))


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


def bag_case(rng: np.random.Generator, N: int, D: int, B: int, L: int):
    """(table (N, D) float32, idx (B, L) int32 with a quarter of the slots
    -1, weights (B, L) float32 in [0.5, 2))."""
    table = rng.normal(size=(N, D)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, L)).astype(np.int32)
    idx[rng.random((B, L)) < 0.25] = -1
    w = rng.uniform(0.5, 2.0, size=(B, L)).astype(np.float32)
    return table, idx, w


def decode_lens(S: int, boundaries) -> tuple:
    """The cache lengths of the reference's sweep (full, a ragged tail,
    one), and one below, at and one above each boundary of the kernel's
    split rule (``flash_decode.split_boundaries``), within ``[1, S]``."""
    lens = {S, S - 17, 1}
    for b in boundaries:
        lens.update((b - 1, b, b + 1))
    return tuple(sorted(n for n in lens if 1 <= n <= S))


def decode_case(rng: np.random.Generator, B: int, Hkv: int, G: int, S: int,
                d: int):
    """(q (B, H, d), k (B, S, Hkv, d), v (B, S, Hkv, d)) float32 normals."""
    q = rng.normal(size=(B, Hkv * G, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    return q, k, v
