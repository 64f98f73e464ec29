"""External-memory CSR construction: build a graph's on-disk tables without
ever holding the edge list in memory.

The port's own copy of ``repro/graph/build.py``, step for step: the same
files and the same :class:`BuildStats` for the same chunks.
``CSRGraph.from_edges`` sorts the whole edge array, O(m) memory, which caps
graph size at RAM.  :func:`build_csr` replaces it with the external
mergesort pipeline of the semi-external model:

1. **Run formation** — edge chunks (an iterator of ``(k, 2)`` arrays, ``.npy``
   shards, or a text edge list) are canonicalized (self loops dropped,
   ``(lo, hi)`` orientation), packed into uint64 keys ``lo << 32 | hi``,
   sorted and locally deduplicated in O(chunk), and written to disk as
   sorted runs.  Degrees are counted later, from the deduped merged stream.
2. **K-way merge** — the runs are memmapped and merged: each round takes
   one block per run, cuts at the minimum of the blocks' last keys (every
   remaining key <= the cut lives in the current blocks), sorts and dedups
   the candidates, and streams the unique keys to the merged edge file.
   Merges cascade with fan-in ``MERGE_FANOUT``, so scratch stays O(chunk)
   however many runs the ingest produced.
3. **CSR emission** — ``indptr`` is the degree cumsum (O(n)); the adjacency
   is an ``open_memmap``-backed ``adj.npy`` filled by a streaming
   symmetrizing scatter with an O(n) write-cursor array.  The merged stream
   is sorted by ``(lo, hi)`` and each edge emits its two directed copies in
   stream order, so every neighbour list comes out ascending: byte for byte
   the ``from_edges`` layout, in ``CSRGraph.save`` format.

Peak memory is O(n) node state + O(chunk) scratch, never O(m).

``relabel="degree"`` re-runs the pipeline over the merged file with ids
permuted so node 0 has the highest degree: the paper's node-ordering lever
(§VI), which packs the late-converging high-degree nodes into a contiguous
id prefix.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
from numpy.lib.format import open_memmap

__all__ = ["build_csr", "BuildStats", "edge_chunks_from_npy", "edge_chunks_from_text"]

# Default ingest/merge chunk: 4M edges = 64 MB of packed keys.
DEFAULT_CHUNK_EDGES = 1 << 22
# adj.npy stores neighbors as int32 (CSRGraph's edge-table dtype), so ids
# must stay within int32 even though the packed uint64 keys could hold more.
_MAX_ID = (1 << 31) - 1
# Max runs merged at once; deeper inputs cascade through merge levels so the
# per-level scratch stays O(MERGE_FANOUT · block) = O(chunk).
MERGE_FANOUT = 8


@dataclass
class BuildStats:
    """What one external-memory build did, and what it cost."""

    n: int
    m: int  # undirected edges after dedup
    edges_ingested: int  # raw input rows (incl. self loops / duplicates)
    chunks: int
    runs: int
    merge_rounds: int
    relabel: str = "none"
    perm: np.ndarray | None = None  # new_id = perm[old_id] (relabel only)
    out_dir: str = ""
    # peak transient scratch (edges) held by any single pipeline stage; the
    # O(n) arrays (degree counter, indptr, write cursor) are reported apart.
    peak_scratch_edges: int = 0
    node_state_bytes: int = 0

    def to_json(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "perm"}
        d["has_perm"] = self.perm is not None
        return d


# ======================================================================
# chunk sources
# ======================================================================
def edge_chunks_from_npy(paths, chunk_edges: int = DEFAULT_CHUNK_EDGES):
    """Yield (k, 2) int64 chunks from .npy edge shards without loading them.

    Each shard is an (E_i, 2) integer array; shards are memmapped and sliced,
    so memory stays O(chunk_edges) regardless of shard size.
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    for p in paths:
        arr = np.load(p, mmap_mode="r")
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"{p}: expected an (E, 2) edge array, got {arr.shape}")
        for lo in range(0, len(arr), chunk_edges):
            yield np.asarray(arr[lo : lo + chunk_edges], dtype=np.int64)


def edge_chunks_from_text(path, chunk_edges: int = DEFAULT_CHUNK_EDGES):
    """Yield (k, 2) int64 chunks from a whitespace-separated edge list.

    Lines starting with ``#`` or ``%`` (SNAP / KONECT headers) are skipped.
    Memory is O(chunk_edges); the file is never read whole.
    """
    buf: list[int] = []
    with open(path) as f:
        for line in f:
            if not line or line[0] in "#%\n":
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            buf.append(int(parts[0]))
            buf.append(int(parts[1]))
            if len(buf) >= 2 * chunk_edges:
                yield np.array(buf, dtype=np.int64).reshape(-1, 2)
                buf = []
    if buf:
        yield np.array(buf, dtype=np.int64).reshape(-1, 2)


def _as_chunks(edges, chunk_edges: int):
    """Normalize any supported edge source into an iterator of (k, 2) arrays."""
    if isinstance(edges, (str, os.PathLike)):
        p = os.fspath(edges)
        if p.endswith(".npy"):
            return edge_chunks_from_npy(p, chunk_edges)
        return edge_chunks_from_text(p, chunk_edges)
    if isinstance(edges, (list, tuple)) and edges and all(
        isinstance(e, (str, os.PathLike)) for e in edges
    ):
        return edge_chunks_from_npy(edges, chunk_edges)
    if isinstance(edges, np.ndarray):
        arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return (arr[lo : lo + chunk_edges] for lo in range(0, len(arr), chunk_edges))
    return iter(edges)


# ======================================================================
# stage 1: run formation
# ======================================================================
def _open_run(ref) -> np.ndarray:
    """Memmap one sorted run: ``ref`` is (path, key count)."""
    path, count = ref
    return np.memmap(path, dtype="<u8", mode="r", shape=(count,))


def _form_runs(chunks, run_dir: str, chunk_edges: int):
    """Canonicalize + locally sort/dedup each chunk into a sorted key run.

    Returns (run refs, rows ingested, chunk count, peak scratch edges,
    max node id seen in any chunk — self loops included — or -1); a run ref
    is ``(path, count)`` over a raw little-endian uint64 key file.
    """
    runs: list[tuple[str, int]] = []
    ingested = 0
    nchunks = 0
    peak = 0
    max_id = -1
    pending: list[np.ndarray] = []  # buffered canonical keys, < chunk_edges total
    pending_total = 0

    def emit(keys_parts: list[np.ndarray]) -> None:
        nonlocal peak
        keys = np.concatenate(keys_parts) if len(keys_parts) > 1 else keys_parts[0]
        keys = np.unique(keys)  # sort + local dedup
        peak = max(peak, int(len(keys)))
        path = os.path.join(run_dir, f"run_{len(runs):05d}.u64")
        keys.astype("<u8").tofile(path)
        runs.append((path, len(keys)))

    for chunk in chunks:
        chunk = np.asarray(chunk, dtype=np.int64).reshape(-1, 2)
        nchunks += 1
        ingested += len(chunk)
        if not len(chunk):
            continue
        u, v = chunk[:, 0], chunk[:, 1]
        chunk_max = max(int(u.max()), int(v.max()))
        if u.min() < 0 or v.min() < 0 or chunk_max > _MAX_ID:
            raise ValueError("node ids must fit in int32 (0 <= id < 2**31)")
        # the id space includes nodes seen only in (dropped) self loops
        max_id = max(max_id, chunk_max)
        keep = u != v  # drop self loops
        lo = np.minimum(u[keep], v[keep]).astype(np.uint64)
        hi = np.maximum(u[keep], v[keep]).astype(np.uint64)
        if not len(lo):
            continue
        keys = (lo << np.uint64(32)) | hi
        # buffer small chunks into full-size runs so a tiny ingest chunk size
        # doesn't explode the run count (degrees are counted post-merge)
        pending.append(keys)
        pending_total += len(keys)
        if pending_total >= chunk_edges:
            emit(pending)
            pending, pending_total = [], 0
    if pending_total:
        emit(pending)
    return runs, ingested, nchunks, peak, max_id


# ======================================================================
# stage 2: vectorized k-way merge with streaming dedup
# ======================================================================
def _merge_runs(runs, out_path: str, merge_block: int):
    """K-way merge sorted uint64 key runs into one deduped sorted raw file.

    Classic cut-at-min-of-block-maxima merge: every remaining key ≤ the cut is
    guaranteed to sit inside the runs' current blocks, so each round is one
    vectorized concat/sort/unique over ≤ num_runs · merge_block keys.

    Returns (total unique keys, merge rounds, peak scratch edges).
    """
    mms = [_open_run(r) for r in runs]
    sizes = [len(a) for a in mms]
    cursors = [0] * len(mms)
    total = 0
    rounds = 0
    peak = 0
    with open(out_path, "wb") as out:
        live = [i for i, s in enumerate(sizes) if s > 0]
        while live:
            rounds += 1
            blocks = []
            lasts = []
            for i in live:
                c = cursors[i]
                blk = np.asarray(mms[i][c : c + merge_block])
                blocks.append(blk)
                lasts.append(blk[-1])
            cut = min(lasts)
            cand = []
            for i, blk in zip(live, blocks):
                take = int(np.searchsorted(blk, cut, side="right"))
                cand.append(blk[:take])
                cursors[i] += take
            merged = np.unique(np.concatenate(cand))
            peak = max(peak, int(sum(len(b) for b in blocks) + len(merged)))
            out.write(merged.tobytes())
            total += len(merged)
            live = [i for i in live if cursors[i] < sizes[i]]
    return total, rounds, peak


def _merge_cascade(runs, scratch: str, out_path: str, chunk_edges: int):
    """Merge any number of runs into ``out_path`` with ≤ MERGE_FANOUT fan-in.

    Every input run lives under the build's private scratch tree, so each
    group's files are unlinked the moment the group is merged — peak disk is
    ~2× the deduped data (consumed level + produced level), and memory is
    O(chunk) regardless of run count.
    """
    merge_block = max(256, chunk_edges // MERGE_FANOUT)
    rounds = 0
    peak = 0
    level = 0
    while len(runs) > MERGE_FANOUT:
        nxt = []
        for i in range(0, len(runs), MERGE_FANOUT):
            group = runs[i : i + MERGE_FANOUT]
            path = os.path.join(scratch, f"merge_L{level}_{i:05d}.u64")
            cnt, r, p = _merge_runs(group, path, merge_block)
            rounds += r
            peak = max(peak, p)
            nxt.append((path, cnt))
            for gpath, _ in group:
                os.unlink(gpath)
        runs = nxt
        level += 1
    m, r, p = _merge_runs(runs, out_path, merge_block)
    for gpath, _ in runs:
        os.unlink(gpath)
    return m, rounds + r, max(peak, p)


# ======================================================================
# stage 3: streaming CSR emission
# ======================================================================
def _iter_unpacked(merged_path: str, m: int, chunk_edges: int):
    """Yield (lo, hi) int64 chunks from a merged uint64 key file (memmapped)."""
    if not m:
        return
    keys = np.memmap(merged_path, dtype="<u8", mode="r", shape=(m,))
    for s in range(0, m, chunk_edges):
        k = np.asarray(keys[s : s + chunk_edges])
        yield (k >> np.uint64(32)).astype(np.int64), (
            k & np.uint64(0xFFFFFFFF)
        ).astype(np.int64)


def _count_degrees(merged_path: str, m: int, n: int, chunk_edges: int) -> np.ndarray:
    """Both-direction degree counts of the merged stream (one O(n) array).

    Per-chunk work is O(chunk log chunk) — only the ids a chunk touches are
    updated, so the pass stays cheap even when n >> chunk (webscale configs).
    """
    deg = np.zeros(n, dtype=np.int64)
    for lo, hi in _iter_unpacked(merged_path, m, chunk_edges):
        for ids in (lo, hi):
            uids, counts = np.unique(ids, return_counts=True)
            deg[uids] += counts
    return deg


def _emit_csr(merged_path: str, m: int, n: int, out_dir: str, chunk_edges: int):
    """Scatter the merged (lo, hi) stream into indptr.npy / adj.npy on disk.

    Two O(n) arrays (degree counter, then write cursor) plus an O(chunk)
    scatter buffer; adj.npy is written through an open_memmap, so the 2m-entry
    edge table never materializes in memory.
    """
    deg = _count_degrees(merged_path, m, n, chunk_edges)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "indptr.npy"), indptr)
    if m == 0:  # np.memmap cannot back a zero-length file
        np.save(os.path.join(out_dir, "adj.npy"), np.zeros(0, dtype=np.int32))
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump({"n": n, "m": 0}, f)
        return
    adj = open_memmap(
        os.path.join(out_dir, "adj.npy"), mode="w+", dtype=np.int32, shape=(2 * m,)
    )
    cursor = indptr[:-1].copy()  # next write slot per node
    for lo, hi in _iter_unpacked(merged_path, m, chunk_edges):
        # interleave the two directed copies edge-by-edge so each node's
        # contributions arrive in global (lo, hi) stream order — that order is
        # ascending per neighbor list (smaller neighbors first via the hi
        # side, larger after via the lo side), i.e. the from_edges layout.
        src = np.stack([lo, hi], axis=1).ravel()
        dst = np.stack([hi, lo], axis=1).ravel()
        order = np.argsort(src, kind="stable")
        s_sorted, d_sorted = src[order], dst[order]
        # within-chunk slot of each directed edge under its source node, via
        # the sorted runs — O(chunk) work, no O(n) temporaries per chunk
        uids, first_idx, counts = np.unique(
            s_sorted, return_index=True, return_counts=True
        )
        offset = np.arange(len(s_sorted), dtype=np.int64) - np.repeat(
            first_idx, counts
        )
        adj[cursor[s_sorted] + offset] = d_sorted.astype(np.int32)
        cursor[uids] += counts
    adj.flush()
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"n": n, "m": m}, f)


def _relabel_chunks(merged_path: str, m: int, perm: np.ndarray, chunk_edges: int):
    """Yield the merged edge stream with ids mapped through ``perm``."""
    for lo, hi in _iter_unpacked(merged_path, m, chunk_edges):
        yield np.stack([perm[lo], perm[hi]], axis=1)


# ======================================================================
# the build
# ======================================================================
def build_csr(
    edges,
    out_dir: str,
    *,
    n: int | None = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    relabel: str = "none",
    tmp_dir: str | None = None,
) -> BuildStats:
    """Build the on-disk CSR tables for an edge stream, out of core.

    ``edges`` may be an iterator/iterable of ``(k, 2)`` integer arrays, a
    ``.npy`` path or list of ``.npy`` shard paths, a text edge-list path, or a
    single in-memory array (chunked internally).  Self loops are dropped,
    duplicates (either orientation) deduplicated, and the result symmetrized.

    ``n`` fixes the node count; by default it is inferred as ``max id + 1``.
    ``relabel="degree"`` additionally permutes ids degree-descending (stable)
    before emission and records the permutation in ``BuildStats.perm``
    (``new = perm[old]``).

    The output directory holds ``indptr.npy`` / ``adj.npy`` / ``meta.json`` —
    the exact :meth:`CSRGraph.save` layout — ready for
    ``CSRGraph.load(out_dir, mmap=True)``.
    """
    if relabel not in ("none", "degree"):
        raise ValueError(f"unknown relabel mode {relabel!r}")
    chunk_edges = max(int(chunk_edges), 1024)
    scratch = tempfile.mkdtemp(prefix="csrbuild_", dir=tmp_dir)
    try:
        run_dir = os.path.join(scratch, "runs")
        os.makedirs(run_dir)
        chunks = _as_chunks(edges, chunk_edges)
        runs, ingested, nchunks, peak1, max_id = _form_runs(
            chunks, run_dir, chunk_edges
        )
        n_inferred = max_id + 1
        if n is None:
            n = n_inferred
        elif n_inferred > n:
            raise ValueError(f"edge endpoints exceed n={n} (max id {n_inferred - 1})")
        n = int(n)

        merged_path = os.path.join(scratch, "merged.u64")
        m, rounds, peak2 = _merge_cascade(runs, scratch, merged_path, chunk_edges)

        perm = None
        if relabel == "degree" and m:
            deg = _count_degrees(merged_path, m, n, chunk_edges)
            order = np.argsort(-deg, kind="stable")  # old ids, new-id order
            perm = np.empty(n, dtype=np.int64)
            perm[order] = np.arange(n, dtype=np.int64)
            # re-run the pipeline over the permuted stream (ids re-ordered =>
            # keys must be re-sorted); dedup is a no-op the second time.
            run_dir2 = os.path.join(scratch, "runs2")
            os.makedirs(run_dir2)
            runs2, _, _, p1, _ = _form_runs(
                _relabel_chunks(merged_path, m, perm, chunk_edges), run_dir2,
                chunk_edges,
            )
            merged_path = os.path.join(scratch, "merged2.u64")
            m2, rounds2, p2 = _merge_cascade(
                runs2, run_dir2, merged_path, chunk_edges
            )
            if m2 != m:  # persisted-output integrity: survive python -O
                raise RuntimeError(
                    f"relabel must be a bijection (merged {m2} keys, expected {m})"
                )
            rounds += rounds2
            peak1, peak2 = max(peak1, p1), max(peak2, p2)
            runs = runs + runs2

        _emit_csr(merged_path, m, n, out_dir, chunk_edges)
        return BuildStats(
            n=n,
            m=m,
            edges_ingested=ingested,
            chunks=nchunks,
            runs=len(runs),
            merge_rounds=rounds,
            relabel=relabel,
            perm=perm,
            out_dir=out_dir,
            peak_scratch_edges=max(peak1, peak2, 1),
            node_state_bytes=int(n * 8 * 3),  # degree counter, cursor, indptr
        )
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
