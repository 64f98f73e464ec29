"""LocalCore (Eq. 1) — the h-index operator over neighbour core values.

The port's own copy of ``repro/core/localcore.py`` (numpy host reference):

* :func:`local_core` — the paper's LocalCore(c_old, nbr(v)) procedure
  (Algorithm 3 lines 11-20), O(deg(v));
* :func:`h_index_batch` / :func:`compute_cnt_batch` — vectorized h-index
  and Eq. 2 counts over flattened CSR segments (the numpy backend).
"""
from __future__ import annotations

import numpy as np

__all__ = ["local_core", "h_index_batch", "compute_cnt_batch"]


def local_core(c_old: int, nbr_cores: np.ndarray) -> int:
    """Paper Algorithm 3, lines 11-20.  Returns the new core upper bound."""
    c_old = int(c_old)
    if c_old <= 0 or len(nbr_cores) == 0:
        return 0
    capped = np.minimum(nbr_cores, c_old)
    num = np.bincount(capped, minlength=c_old + 1)
    # s(k) = #{u : min(core(u), c_old) >= k} scanned from k = c_old down
    suffix = np.cumsum(num[::-1])[::-1]
    ks = np.arange(c_old + 1)
    ok = np.flatnonzero(suffix[1:] >= ks[1:])
    return int(ok[-1] + 1) if len(ok) else 0


def h_index_batch(vals: np.ndarray, seg_ptr: np.ndarray) -> np.ndarray:
    """h-index per segment of a flattened, CSR-style value array: with
    values sorted descending within a segment, h = #{i : v_i >= i+1}."""
    P = len(seg_ptr) - 1
    lens = np.diff(seg_ptr)
    if len(vals) == 0:
        return np.zeros(P, dtype=np.int64)
    seg_ids = np.repeat(np.arange(P, dtype=np.int64), lens)
    order = np.lexsort((-vals, seg_ids))
    sv = vals[order]
    start = np.repeat(seg_ptr[:-1], lens)
    rank = np.arange(len(vals), dtype=np.int64) - start
    contrib = (sv >= rank + 1).astype(np.int64)
    return np.bincount(seg_ids, weights=contrib, minlength=P).astype(np.int64)


def compute_cnt_batch(vals: np.ndarray, seg_ptr: np.ndarray,
                      thresholds: np.ndarray) -> np.ndarray:
    """cnt per segment: #{u in segment : vals(u) >= threshold} (Eq. 2)."""
    P = len(seg_ptr) - 1
    lens = np.diff(seg_ptr)
    if len(vals) == 0:
        return np.zeros(P, dtype=np.int64)
    seg_ids = np.repeat(np.arange(P, dtype=np.int64), lens)
    thr = np.repeat(thresholds, lens)
    return np.bincount(
        seg_ids, weights=(vals >= thr).astype(np.int64), minlength=P
    ).astype(np.int64)
