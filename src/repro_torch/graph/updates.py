"""Edge-update memory buffer (paper §V.A, *Graph Maintenance*).

The port's own copy of ``repro/graph/updates.py``.  A bounded in-memory
buffer holds the latest inserted/deleted edges, indexed by endpoint;
``nbr(v)`` reads merge the CSR list with the buffered deltas.  When the
buffer fills, the CSR is rewritten ("flushed") and the buffer cleared.
"""
from __future__ import annotations

import numpy as np

from .storage import CSRGraph

__all__ = ["BufferedGraph"]


def _pair_add(index: dict[int, set[int]], u: int, v: int) -> None:
    index.setdefault(u, set()).add(v)
    index.setdefault(v, set()).add(u)


def _pair_discard(index: dict[int, set[int]], u: int, v: int) -> None:
    """Drop (u, v) from both endpoint sets, removing emptied entries, so the
    index's footprint tracks the buffered updates only."""
    for a, b in ((u, v), (v, u)):
        s = index.get(a)
        if s is not None:
            s.discard(b)
            if not s:
                del index[a]


class BufferedGraph:
    """A CSRGraph plus an edge-update buffer with merged neighbour reads.

    ``_ins``/``_del`` are plain dicts, never defaultdicts: a membership
    probe on a defaultdict would materialise an empty set per probed node.
    """

    def __init__(self, graph: CSRGraph, buffer_capacity: int = 1 << 16):
        self.base = graph
        self.capacity = int(buffer_capacity)
        self._ins: dict[int, set[int]] = {}
        self._del: dict[int, set[int]] = {}
        self._size = 0
        self._deg_delta = np.zeros(graph.n, dtype=np.int64)
        self.flushes = 0
        self._flush_hooks: list = []
        # structural version: bumped by every applied update and every
        # flush; the device-resident edge table is cached against it
        self.version = 0

    def add_flush_hook(self, fn) -> None:
        """Register ``fn(self)`` to run after every CSR rewrite (flush): a
        flush invalidates any reader state pointed at the old CSR arrays."""
        self._flush_hooks.append(fn)

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def m(self) -> int:
        return self.base.m + self._size

    def degree(self, v: int) -> int:
        return self.base.degree(v) + int(self._deg_delta[v])

    def degrees(self) -> np.ndarray:
        return self.base.degrees() + self._deg_delta

    def insert_edge(self, u: int, v: int) -> bool:
        """Insert (u, v); returns False if the edge already exists."""
        if u == v:
            return False
        if v in self._ins.get(u, ()):
            return False
        if v in self._del.get(u, ()):  # re-inserting a buffered deletion
            _pair_discard(self._del, u, v)
            self._size -= 1
        else:
            if self.base.has_edge(u, v):
                return False
            _pair_add(self._ins, u, v)
            self._size += 1
        self._deg_delta[u] += 1
        self._deg_delta[v] += 1
        self.version += 1
        self._maybe_flush()
        return True

    def delete_edge(self, u: int, v: int) -> bool:
        """Delete (u, v); returns False if the edge does not exist."""
        if v in self._del.get(u, ()):
            return False
        if v in self._ins.get(u, ()):
            _pair_discard(self._ins, u, v)
            self._size -= 1
        else:
            if not self.base.has_edge(u, v):
                return False
            _pair_add(self._del, u, v)
            self._size += 1
        self._deg_delta[u] -= 1
        self._deg_delta[v] -= 1
        self.version += 1
        self._maybe_flush()
        return True

    def merged_neighbors(self, v: int, disk_nbrs: np.ndarray) -> np.ndarray:
        """Apply buffered deltas for v to its CSR adjacency list."""
        dels = self._del.get(v)
        ins = self._ins.get(v)
        if not dels and not ins:
            return disk_nbrs
        out = disk_nbrs
        if dels:
            out = out[~np.isin(out, np.fromiter(dels, dtype=np.int32))]
        if ins:
            out = np.concatenate([out, np.fromiter(ins, dtype=np.int32)])
        return out

    def _maybe_flush(self) -> None:
        if self._size >= self.capacity:
            self.flush()

    def flush(self) -> None:
        """Rewrite the CSR applying all buffered updates."""
        if self._size == 0:
            return
        e = self.base.edge_list()  # each edge once, u < v
        dels = {(min(u, v), max(u, v))
                for u, vs in self._del.items() for v in vs}
        if dels:
            # one int64 key per edge (u * n + v): the filter is vectorised,
            # the kept edges stay in edge_list order
            n64 = np.int64(max(self.n, 1))
            gone = np.array(sorted(dels), dtype=np.int64)
            e = e[~np.isin(e[:, 0] * n64 + e[:, 1],
                           gone[:, 0] * n64 + gone[:, 1])]
        adds = {(min(u, v), max(u, v))
                for u, vs in self._ins.items() for v in vs}
        if adds:
            e = np.concatenate([e, np.array(sorted(adds), dtype=np.int64)])
        self.base = CSRGraph.from_edges(self.n, e, dedup=False)
        self._ins.clear()
        self._del.clear()
        self._size = 0
        self._deg_delta[:] = 0
        self.flushes += 1
        self.version += 1
        for fn in self._flush_hooks:
            fn(self)

    def materialize(self) -> CSRGraph:
        """Flush and return the up-to-date CSR."""
        self.flush()
        return self.base
