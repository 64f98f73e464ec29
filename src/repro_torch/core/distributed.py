"""Sharded graph layout for the shard backend.

The port's counterpart of ``repro/core/distributed.py``.  The paper's
memory contract over a list of devices:

  * edge table  -> per-shard CSR blocks of *contiguous node ranges*
    balanced by edge count (the paper's sequential adjacency layout, so
    every owned node's LocalCore needs only local edges);
  * node state  -> the ``core`` array replicated O(n) per device;
  * one pass    -> one superstep: the h-index refresh of each shard's owned
    rows from the pass-start core, then one gather of the owned slices
    (edge shards never move).

This module is the *layout* half, numpy only and bit for bit the
reference's: :func:`balanced_bounds` cuts, :func:`shard_arrays` the
stacked rectangular per-shard arrays, :func:`shard_graph` for a plain
:class:`CSRGraph`, and :func:`sharded_graph_specs` the ``(shape, dtype)``
pairs of those arrays.  The execution half is
:class:`repro_torch.core.engine.ShardedBackend` over
:func:`repro_torch.core.resident.run_sharded`; :func:`distributed_decompose`
is a thin wrapper over it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.storage import CSRGraph

__all__ = [
    "ShardedGraph",
    "shard_arrays",
    "shard_graph",
    "shard_layout",
    "balanced_bounds",
    "sharded_graph_specs",
    "distributed_decompose",
]


@dataclass
class ShardedGraph:
    """Stacked per-shard CSR arrays (leading dim = number of shards).

    ``lsegptr`` holds each shard's *local* CSR offsets over its padded edge
    axis (empty segments for padding slots).  ``pad_edges`` /
    ``per_shard_edges`` surface the padding cost of the rectangular (S, E)
    layout; the minimax balance keeps it minimal for contiguous ranges.
    """

    dst: np.ndarray        # (S, E) int32  — edge targets, padded
    rows: np.ndarray       # (S, E) int32  — local owner-row per edge
    edge_mask: np.ndarray  # (S, E) bool
    owned_ids: np.ndarray  # (S, V) int32  — global node id per local slot (pad -> n)
    owned_mask: np.ndarray # (S, V) bool
    lsegptr: np.ndarray    # (S, V+1) int32 — local flat-table offsets
    bounds: np.ndarray     # (S+1,) int64  — contiguous node-range cuts
    deg: np.ndarray        # (n,)  int32   — global degrees (core init)
    n: int
    num_probes: int        # binary-search probes = ceil(log2(max_deg + 2))
    pad_edges: int         # S * E - total directed edges (wasted slots)
    per_shard_edges: np.ndarray  # (S,) int64 — real edges per shard


def _validate_int32(total_edges: int, n: int) -> None:
    """The device shard tables are int32 end to end (ids, offsets): fail
    loudly instead of wrapping offsets negative (the guard
    ``resident.build_structure`` applies to the flat table)."""
    if total_edges >= (1 << 31) or n >= (1 << 31):
        raise ValueError(
            f"sharded edge table needs int32 offsets: 2m={total_edges} "
            f"n={n} exceeds 2**31; raise num_shards only splits the edge "
            "axis, not the id space — use the numpy backend for this graph")


def balanced_bounds(seg_ptr: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous node-range cuts minimizing the max per-shard edge count.

    Binary-search the smallest feasible load L, with greedy feasibility via
    ``searchsorted`` (each range takes the longest prefix fitting in L; a
    node's adjacency never splits, and L >= max degree guarantees
    progress).  O(S log n log m).
    """
    n = len(seg_ptr) - 1
    S = max(1, int(num_shards))
    total = int(seg_ptr[-1])
    if n == 0:
        return np.zeros(S + 1, dtype=np.int64)
    deg = np.diff(seg_ptr)
    lo = max(int(deg.max()) if n else 0, -(-total // S))
    hi = total

    def cuts(L):
        bounds = np.empty(S + 1, dtype=np.int64)
        bounds[0] = 0
        cur = 0
        for s in range(S):
            if cur >= n:
                bounds[s + 1] = n
                continue
            nxt = int(np.searchsorted(seg_ptr, seg_ptr[cur] + L,
                                      side="right")) - 1
            bounds[s + 1] = cur = max(min(nxt, n), cur + 1)
        return bounds if bounds[-1] >= n else None

    while lo < hi:
        mid = (lo + hi) // 2
        if cuts(mid) is not None:
            hi = mid
        else:
            lo = mid + 1
    return cuts(lo)


def shard_layout(seg_ptr: np.ndarray, num_shards: int, n: int) -> dict:
    """The host half of :func:`shard_arrays` without the (S, E) edge
    arrays: ``bounds``, ``per_shard_edges``, ``pad_edges`` (the rectangular
    layout's), ``owned_ids`` and ``owned_mask`` (S, V), int32-validated."""
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    total = int(seg_ptr[-1])
    _validate_int32(total, n)
    S = max(1, int(num_shards))
    bounds = balanced_bounds(seg_ptr, S)
    per_shard = (seg_ptr[bounds[1:]] - seg_ptr[bounds[:-1]]).astype(np.int64)
    max_nodes = int(max(1, np.diff(bounds).max() if n else 1))
    max_edges = int(max(1, per_shard.max()))
    owned = np.full((S, max_nodes), n, dtype=np.int32)
    omask = np.zeros((S, max_nodes), dtype=bool)
    for s in range(S):
        lo_v, hi_v = int(bounds[s]), int(bounds[s + 1])
        owned[s, :hi_v - lo_v] = np.arange(lo_v, hi_v, dtype=np.int32)
        omask[s, :hi_v - lo_v] = True
    return dict(bounds=bounds, per_shard_edges=per_shard,
                pad_edges=S * max_edges - total, owned_ids=owned,
                owned_mask=omask, max_edges=max_edges)


def shard_arrays(adj: np.ndarray, seg_ptr: np.ndarray, num_shards: int,
                 n: int | None = None) -> ShardedGraph:
    """Cut a flat CSR (``adj`` targets, ``seg_ptr`` offsets) into stacked
    per-shard arrays over minimax-balanced contiguous node ranges."""
    n = len(seg_ptr) - 1 if n is None else int(n)
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    lay = shard_layout(seg_ptr, num_shards, n)
    bounds = lay["bounds"]
    S, max_nodes = lay["owned_ids"].shape
    max_edges = lay["max_edges"]
    dst = np.zeros((S, max_edges), dtype=np.int32)
    rows = np.zeros((S, max_edges), dtype=np.int32)
    emask = np.zeros((S, max_edges), dtype=bool)
    lseg = np.zeros((S, max_nodes + 1), dtype=np.int32)
    for s in range(S):
        lo_v, hi_v = int(bounds[s]), int(bounds[s + 1])
        e0, e1 = int(seg_ptr[lo_v]), int(seg_ptr[hi_v])
        ne, nv = e1 - e0, hi_v - lo_v
        dst[s, :ne] = adj[e0:e1]
        local_deg = np.diff(seg_ptr[lo_v: hi_v + 1]).astype(np.int64)
        rows[s, :ne] = np.repeat(np.arange(nv, dtype=np.int32), local_deg)
        emask[s, :ne] = True
        lseg[s, : nv + 1] = (seg_ptr[lo_v: hi_v + 1] - e0).astype(np.int32)
        lseg[s, nv + 1:] = ne  # padding slots: empty trailing segments
    deg = np.diff(seg_ptr).astype(np.int32)
    dmax = int(deg.max()) if n else 0
    return ShardedGraph(
        dst=dst, rows=rows, edge_mask=emask, owned_ids=lay["owned_ids"],
        owned_mask=lay["owned_mask"], lsegptr=lseg, bounds=bounds, deg=deg,
        n=n, num_probes=max(1, int(np.ceil(np.log2(dmax + 2)))),
        pad_edges=lay["pad_edges"], per_shard_edges=lay["per_shard_edges"],
    )


def shard_graph(graph: CSRGraph, num_shards: int) -> ShardedGraph:
    """Contiguous node-range shards of a plain CSR, balanced by edge count."""
    return shard_arrays(np.asarray(graph.adj), graph.indptr, num_shards,
                        n=graph.n)


def sharded_graph_specs(
    n: int, m_directed: int, num_shards: int, max_deg: int
) -> tuple[dict, int, int]:
    """``(shape, dtype)`` of each stacked shard array at a config's size,
    the binary-search probes and the owned slots per shard ``V`` (the
    reference's ShapeDtypeStructs, for sizing without building)."""
    V = -(-n // num_shards) + 1
    E = int(m_directed / num_shards * 1.05) + 8  # balanced-cut slack
    S = num_shards
    i32, b = torch.int32, torch.bool
    specs = dict(
        dst=((S, E), i32),
        rows=((S, E), i32),
        edge_mask=((S, E), b),
        lsegptr=((S, V + 1), i32),
        owned_ids=((S, V), i32),
        owned_mask=((S, V), b),
        cnt=((S, V), i32),
        active=((S, V), b),
        nactive=((), i32),
    )
    probes = max(1, int(np.ceil(np.log2(max_deg + 2))))
    return specs, probes, V


def distributed_decompose(
    graph: CSRGraph,
    devices=None,
    star_gating: bool = True,
    core0: np.ndarray | None = None,
    max_supersteps: int | None = None,
):
    """Thin wrapper over the ``shard`` backend: shard, run the fixpoint,
    return (core, supersteps).

    ``devices`` (the reference's ``mesh``) lists one device per shard and
    may repeat a device; ``None`` takes every visible GPU.  With ``core0``
    given (a checkpointed intermediate state or post-deletion upper
    bounds), performs a warm restart: any upper-bound state is a valid
    init, and the exact-cnt prologue re-derives cnt.  ``max_supersteps``
    budgets the run exactly; the returned core is then a valid upper-bound
    checkpoint rather than the fixpoint.
    """
    from .engine import ShardedBackend
    from .resident import run_resident
    from .semicore import HostEngine

    backend = ShardedBackend(devices=devices)
    eng = HostEngine(graph)
    if core0 is not None:
        warm = np.minimum(np.asarray(core0, dtype=np.int64),
                          eng.degrees()).astype(np.int64)
        r = run_resident(eng, "semicore*", backend, core=warm,
                         initial_cnt_scan=True, max_supersteps=max_supersteps)
    else:
        algo = "semicore*" if star_gating else "semicore"
        r = run_resident(eng, algo, backend, max_supersteps=max_supersteps)
    return np.asarray(r.core), int(r.iterations)
