"""Graph storage: CSR node/edge tables with blocked, I/O-accounted access.

The port's own copy of ``repro/graph/storage.py``.  The **edge table**
stores ``nbr(v_1), nbr(v_2), ...`` consecutively; the **node table** the
offset of every node.  The edge table is cut into blocks of
``block_edges`` edges, the unit of I/O accounting under the
external-memory model.

Two backings sit behind the one :class:`CSRGraph`: in-memory numpy arrays,
and ``indptr.npy`` / ``adj.npy`` / ``meta.json`` on disk, opened with
``np.memmap`` by :meth:`CSRGraph.load` (the edge table stays on disk).
Graphs too large for ``CSRGraph.from_edges`` (whole-array sorts) are built
in that layout by :func:`repro_torch.graph.build.build_csr` with O(n) +
O(chunk) peak memory.

:class:`BlockReader` models the paper's single block buffer, generalised
to an LRU pool by ``pool_blocks`` (``1`` is the paper's model exactly).
Each block fill passes the ``block.read`` fault hook of
:mod:`repro_torch.faults.fs`, and an optional ``retry`` policy retries a
failed fill.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..faults import fs as _faults
from ..obs import metrics as _metrics

__all__ = [
    "CSRGraph",
    "BlockReader",
    "paper_example_graph",
    "DEFAULT_BLOCK_EDGES",
]

# Registry mirrors of the paper's I/O accounting, incremented at the same
# lines as the reader's own counters so deltas reconcile with DecompResult.
_IO_READS = _metrics.counter(
    "repro_io_edge_block_reads_total",
    "Edge-table block read I/Os under the paper's blocked access model",
).labels()
_IO_HITS = _metrics.counter(
    "repro_io_edge_block_pool_hits_total",
    "Edge-table block reads answered from a resident buffer-pool block",
).labels()
_IO_EVICTIONS = _metrics.counter(
    "repro_io_edge_block_evictions_total",
    "LRU buffer-pool evictions of edge-table blocks",
).labels()
_IO_NODE_READS = _metrics.counter(
    "repro_io_node_table_reads_total",
    "Node-table block read I/Os (sequential node scans)",
).labels()
_IO_BYTES = _metrics.counter(
    "repro_io_bytes_read_total",
    "Bytes read under the blocked I/O model (edge + node table)",
).labels()

# 4096 edges * 4 bytes = 16 KiB per block.
DEFAULT_BLOCK_EDGES = 4096


@dataclass
class CSRGraph:
    """Undirected graph in CSR form (each edge stored in both endpoint lists).

    ``indptr``  -- int64 array of shape (n + 1,): the node table offsets.
    ``adj``     -- int32 array of shape (2m,): the edge table.
    """

    indptr: np.ndarray
    adj: np.ndarray

    def __post_init__(self) -> None:
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        # adj may be a memmap (the edge table on disk): an int32 array is
        # kept as it is, so loading never copies the table into memory
        if not (isinstance(self.adj, np.ndarray)
                and self.adj.dtype == np.int32):
            self.adj = np.asarray(self.adj, dtype=np.int32)

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        """Number of *undirected* edges."""
        return len(self.adj) // 2

    @property
    def num_directed(self) -> int:
        return len(self.adj)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.adj[self.indptr[v]: self.indptr[v + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        return bool(np.isin(v, self.neighbors(u)).item())

    @classmethod
    def from_edges(cls, n: int, edges: np.ndarray, *,
                   dedup: bool = True) -> "CSRGraph":
        """Build from an (E, 2) array of undirected edges (any orientation).

        Self loops are dropped; parallel edges are deduplicated when
        ``dedup``.  Neighbour lists come out sorted.  Both steps sort one
        int64 key ``src * n + dst`` per edge (the reference sorts index
        pairs; the layout is the same).
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if len(edges):
            edges = edges[edges[:, 0] != edges[:, 1]]
        n64 = np.int64(max(n, 1))
        if dedup and len(edges):
            lo = np.minimum(edges[:, 0], edges[:, 1])
            hi = np.maximum(edges[:, 0], edges[:, 1])
            key = np.unique(lo * n64 + hi)
            lo = key // n64
            edges = np.stack([lo, key - lo * n64], axis=1)
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        counts = np.bincount(src, minlength=n).astype(np.int64)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        key = np.sort(src * n64 + dst)
        return cls(indptr=indptr, adj=(key - key // n64 * n64).astype(np.int32))

    def edge_list(self) -> np.ndarray:
        """Return (m, 2) array with each undirected edge once (u < v)."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        dst = self.adj.astype(np.int64)
        mask = src < dst
        return np.stack([src[mask], dst[mask]], axis=1)

    def directed_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) for every directed copy (2m entries), src sorted."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return src, self.adj

    def induced_subgraph(self, nodes: np.ndarray) -> "CSRGraph":
        """Induced subgraph with nodes relabeled 0..len(nodes)-1."""
        nodes = np.asarray(nodes, dtype=np.int64)
        remap = np.full(self.n, -1, dtype=np.int64)
        remap[nodes] = np.arange(len(nodes))
        e = self.edge_list()
        keep = (remap[e[:, 0]] >= 0) & (remap[e[:, 1]] >= 0)
        return CSRGraph.from_edges(len(nodes), remap[e[keep]], dedup=False)

    def sample_edges(self, frac: float, seed: int = 0) -> "CSRGraph":
        """Keep a random fraction of edges (incident nodes kept; §VI-C)."""
        e = self.edge_list()
        keep = np.random.default_rng(seed).random(len(e)) < frac
        return CSRGraph.from_edges(self.n, e[keep], dedup=False)

    def sample_nodes(self, frac: float, seed: int = 0) -> "CSRGraph":
        """Induced subgraph of a random node sample (§VI-C)."""
        rng = np.random.default_rng(seed)
        return self.induced_subgraph(np.flatnonzero(rng.random(self.n) < frac))

    def relabel(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel node ids: new id of old node v is perm[v]."""
        perm = np.asarray(perm, dtype=np.int64)
        return CSRGraph.from_edges(self.n, perm[self.edge_list()], dedup=False)

    def save(self, path: str) -> None:
        """Write ``indptr.npy``, ``adj.npy`` and ``meta.json`` under ``path``
        (the layout :func:`repro_torch.graph.build.build_csr` emits)."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "indptr.npy"), self.indptr)
        np.save(os.path.join(path, "adj.npy"), self.adj)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "m": self.m}, f)

    @classmethod
    def load(cls, path: str, *, mmap: bool = True) -> "CSRGraph":
        """Open a saved graph; with ``mmap`` the tables stay on disk and
        ``adj`` is an ``np.memmap`` (read-only)."""
        mode = "r" if mmap else None
        return cls(indptr=np.load(os.path.join(path, "indptr.npy"),
                                  mmap_mode=mode),
                   adj=np.load(os.path.join(path, "adj.npy"),
                               mmap_mode=mode))


class BlockReader:
    """Block-granular, I/O-accounted access to the edge table.

    A single in-memory block buffer: reading edge positions within the
    buffered block is free, any other block costs one read I/O.  Sequential
    full scans cost ``ceil(2m / B)`` I/Os; SemiCore+/SemiCore* pay one I/O
    per distinct block touched.  ``pool_blocks`` > 1 turns the buffer into
    an LRU pool (hits are free, misses evict the least recently used).
    ``retry`` (a :class:`repro_torch.faults.RetryPolicy`) retries a block
    fill that raised ``OSError``.
    """

    def __init__(self, graph: CSRGraph, block_edges: int = DEFAULT_BLOCK_EDGES,
                 pool_blocks: int = 1, retry=None):
        self.graph = graph
        self.block_edges = int(block_edges)
        self.pool_blocks = max(1, int(pool_blocks))
        self.retry = retry
        self.reads = 0  # edge-table block read I/Os
        self.node_table_reads = 0  # node-table block read I/Os
        self.hits = 0  # pool hits
        self._pool: OrderedDict[int, None] = OrderedDict()  # LRU order
        # node-table entries are (offset 8B, degree 4B) = 12 bytes; one block
        # is block_edges * 4 bytes
        self._node_entries_per_block = max(1, (self.block_edges * 4) // 12)

    @property
    def num_blocks(self) -> int:
        return -(-self.graph.num_directed // self.block_edges)

    def invalidate(self) -> None:
        """Drop every resident block (the backing CSR was rewritten)."""
        self._pool.clear()

    def reset_io(self) -> None:
        self.reads = 0
        self.node_table_reads = 0
        self.hits = 0
        self.invalidate()

    @property
    def bytes_read(self) -> int:
        return (self.reads + self.node_table_reads) * self.block_edges * 4

    @property
    def resident_blocks(self) -> tuple[int, ...]:
        """Resident block ids, least- to most-recently used."""
        return tuple(self._pool)

    def _touch(self, block: int) -> None:
        pool = self._pool
        if block in pool:
            pool.move_to_end(block)
            self.hits += 1
            _IO_HITS.inc()
            return
        self.reads += 1
        _IO_READS.inc()
        _IO_BYTES.inc(self.block_edges * 4)
        pool[block] = None
        while len(pool) > self.pool_blocks:
            pool.popitem(last=False)
            _IO_EVICTIONS.inc()

    def charge_pass(self, blocks: np.ndarray) -> None:
        """Account one batch pass touching ``blocks`` (distinct, ascending).

        With one buffer every covered block costs one read per pass and the
        buffer state is untouched.  With a pool, LRU is simulated exactly:
        only blocks resident at pass start can hit, and for a resident block
        at pass position ``i`` with pass-start LRU rank ``rho`` the number of
        distinct fresher blocks at its touch is ``i + (|resident| - 1 - rho)
        - #(earlier touches of residents fresher than rho)``.
        """
        blocks = np.asarray(blocks, dtype=np.int64)
        k = len(blocks)
        if self.pool_blocks == 1:
            self.reads += k
            _IO_READS.inc(k)
            _IO_BYTES.inc(k * self.block_edges * 4)
            return
        if k == 0:
            return
        pool = self._pool
        P = self.pool_blocks
        hits = 0
        resident = np.fromiter(pool.keys(), np.int64, len(pool))  # LRU -> MRU
        if len(resident):
            order = np.argsort(resident)
            pos = np.searchsorted(resident[order], blocks)
            pos = np.minimum(pos, len(resident) - 1)
            cand = np.flatnonzero(resident[order][pos] == blocks)
            rhos = order[pos[cand]]
            nres = len(resident)
            seen: list[int] = []
            for i, rho in zip(cand.tolist(), rhos.tolist()):
                fresher = i + (nres - 1 - rho) - sum(1 for r in seen if r > rho)
                if fresher < P:
                    hits += 1
                seen.append(rho)
        self.reads += k - hits
        self.hits += hits
        _IO_READS.inc(k - hits)
        _IO_HITS.inc(hits)
        _IO_BYTES.inc((k - hits) * self.block_edges * 4)
        # post-pass pool: untouched residents (old recency order), then the
        # pass tail
        untouched = resident[~np.isin(resident, blocks)] if len(resident) \
            else resident
        end_size = min(len(untouched) + k, P)
        _IO_EVICTIONS.inc((k - hits) - (end_size - len(resident)))
        pool.clear()
        for b in untouched[max(0, len(untouched) + k - P):].tolist():
            pool[b] = None
        for b in blocks[max(0, k - P):].tolist():
            pool[b] = None

    def _fill_span(self, first: int, last: int) -> list[int]:
        """Touch blocks ``first..last``, fetching the missing ones; returns
        the blocks this call filled.

        The fault hook (standing in for the disk read) runs *before* a
        missing block is charged or made resident, so a failed fill leaves
        no pool entry and no charge behind: a retried read misses again and
        is charged once.  Blocks filled earlier in the span stay resident
        across a mid-span failure (their data arrived), and the retry hits
        them.
        """
        filled: list[int] = []
        for b in range(first, last + 1):
            if b not in self._pool:
                _faults.on_op("block.read")  # may raise a transient IOError
                filled.append(b)
            self._touch(b)
        return filled

    def load_neighbors(self, v: int) -> np.ndarray:
        """Load nbr(v), touching every block the adjacency list spans."""
        lo = int(self.graph.indptr[v])
        hi = int(self.graph.indptr[v + 1])
        if hi > lo:
            first = lo // self.block_edges
            last = (hi - 1) // self.block_edges
            if self.retry is None:
                filled = self._fill_span(first, last)
            else:
                filled = self.retry.call(self._fill_span, first, last,
                                         op="block.read")
            try:
                return self.graph.adj[lo:hi]
            except OSError:
                # a block charged as read never delivered its bytes (a
                # memmap page-in failure): drop this call's fills and undo
                # their charges, so residency never lies about the disk
                for b in filled:
                    if b in self._pool:
                        del self._pool[b]
                        self.reads -= 1
                raise
        return self.graph.adj[lo:hi]

    def account_node_table_scan(self, v_lo: int, v_hi: int) -> None:
        """Charge node-table I/O for sequentially scanning nodes [v_lo, v_hi]."""
        if v_hi < v_lo:
            return
        blocks = -(-(v_hi - v_lo + 1) // self._node_entries_per_block)
        self.node_table_reads += blocks
        _IO_NODE_READS.inc(blocks)
        _IO_BYTES.inc(blocks * self.block_edges * 4)


def paper_example_graph() -> CSRGraph:
    """The 9-node, 15-edge running example of the paper (Fig. 1): cores
    {v0..v3: 3, v4..v7: 2, v8: 1}."""
    edges = np.array(
        [
            (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),  # K4: the 3-core
            (2, 4),
            (3, 4), (3, 5), (3, 6),
            (4, 5),
            (5, 6), (5, 7), (5, 8),
            (6, 7),
        ],
        dtype=np.int64,
    )
    return CSRGraph.from_edges(9, edges)
