"""CoreWriter: the write side of the CQRS-split streaming core service.

The paper's semi-external contract — O(n) node state in memory, edge table on
disk — is exactly the shape of a long-lived serving process, and §V's
maintenance algorithms are built for continuous updates.  The service is
split CQRS-style:

* **writes** (``CoreWriter``, this module) — an edge-update stream ingested
  in micro-batches.  Each batch is admitted (normalized / coalesced /
  deletes-first, see admission.py), logged to the write-ahead log as a
  typed op record, then applied through ``CoreMaintainer.apply`` (the
  parallel grouped settle, or SemiDelete*/SemiInsert* when disabled),
  keeping ``core``/``cnt`` exact after every batch;
* **reads** (``QueryAPI``, shared) — ``coreness``, k-core membership, top-k
  by coreness and the degeneracy, answered from an immutable *epoch view*:
  a frozen copy of the O(n) node arrays published atomically after each
  batch commit.  Readers never observe a half-applied batch, and the query
  path performs **zero edge-table I/O** — it never touches the BlockReader.
  Set queries are memoized in an LRU cache that is invalidated on every
  epoch publish.  The same query surface is served by ``CoreReplica``
  (replica.py) from its own WAL-tailed epoch views, which is what lets
  reads scale independently of the single writer;
* **durability** — the WAL records a batch before it is applied; periodic
  snapshots dump (epoch, CSR, core, cnt) atomically and rotate the WAL past
  the snapshot epoch.  Recovery replays the WAL tail structurally and
  warm-restarts SemiCore* from a provable upper bound instead of
  recomputing from scratch.

``CoreService`` remains as the established name of the writer (it serves
both roles in a single-process deployment).

The port's own copy of ``repro/stream/service.py``.  What differs is where
the settle runs: ``backend=None`` resolves ``REPRO_TORCH_BACKEND`` (default
``"cuda"``, the fused superstep kernels) where the reference resolves to
numpy, and ``device=`` places it — ``None`` is the first GPU and raises
without one, ``device="cpu"`` runs the kernels' plain versions on the host.
The writer's maintainer, recovery's warm settle (``device`` through
``service_kwargs``) and the replica's bootstrap all take it.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..core.engine import warm_settle
from ..core.maintenance import CoreMaintainer
from ..core.semicore import HostEngine
from ..core.update import Delete, UpdateBatch
from ..graph.storage import CSRGraph, DEFAULT_BLOCK_EDGES
from ..graph.updates import BufferedGraph
from ..obs import metrics as _metrics, trace as _trace
from .admission import AdmittedBatch, admit_batch
from .backpressure import AdmissionController, Overloaded
from .wal import CorruptionError, SnapshotStore, WriteAheadLog

__all__ = [
    "EpochView", "BatchStats", "RecoveryStats", "QueryAPI",
    "CoreWriter", "CoreService", "Overloaded",
    "Watermarked", "WatermarkedArray",
]

# Service-level instrumentation.  Per-kind query series are
# hoisted once at import so the hot query path pays one perf_counter pair and
# two attribute bumps, nothing else.
_INGEST_SECONDS = _metrics.histogram(
    "repro_service_ingest_seconds",
    "End-to-end micro-batch ingest latency (admit + WAL + apply + publish)",
)
_INGESTS = _metrics.counter(
    "repro_service_batches_total", "Micro-batches ingested").labels()
_QUERY_SECONDS = _metrics.histogram(
    "repro_service_query_seconds", "Query latency by kind")
_QUERIES = _metrics.counter(
    "repro_service_queries_total", "Queries served by kind")
_EPOCH_GAUGE = _metrics.gauge(
    "repro_service_epoch", "Committed epoch watermark").labels()
_BUFFERED_GAUGE = _metrics.gauge(
    "repro_service_buffered_updates",
    "Structural updates buffered in the BufferedGraph awaiting flush").labels()
_QUERY_KINDS = ("coreness", "in_kcore", "kcore_members", "top_k", "degeneracy")
_QOBS = {
    k: (_QUERIES.labels(kind=k), _QUERY_SECONDS.labels(kind=k))
    for k in _QUERY_KINDS
}


# ======================================================= watermarked replies
class Watermarked(int):
    """An int query reply carrying the epoch watermark it was answered at.

    Behaves exactly like ``int`` (equality, hashing, arithmetic) so existing
    callers never notice; readers that care about staleness check ``.epoch``.
    """

    def __new__(cls, value, epoch: int):
        self = super().__new__(cls, value)
        self.epoch = int(epoch)
        return self


class WatermarkedArray(np.ndarray):
    """ndarray view subclass whose ``.epoch`` is the reply's watermark.

    Created as a zero-copy view, so readonly flags and values are exactly the
    wrapped array's — cached replies stay shared and immutable.

    Watermark propagation semantics (pinned by the stream tests):

    * **derived arrays keep the source epoch** — slices, views, reshapes,
      copies and single-source ufunc results (``members + 1``) answer for
      the same epoch their data came from;
    * **mixed-epoch operands drop to ``None``** — combining replies from
      different epochs produces data that answers for *no* well-defined
      epoch, and a ``None`` watermark says so instead of silently inheriting
      whichever operand numpy templated the result from (the pre-fix
      behavior).  Operands without a watermark (plain ndarrays, scalars, or
      an unstamped ``WatermarkedArray``) don't constrain the epoch: mixing
      a reply with constants keeps the reply's epoch.
    """

    #: class-level default: an array that never got stamped has no watermark.
    epoch = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self.epoch = getattr(obj, "epoch", None)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        epochs = {
            x.epoch for x in inputs
            if isinstance(x, WatermarkedArray) and x.epoch is not None
        }
        epoch = epochs.pop() if len(epochs) == 1 else None
        # compute on the plain ndarray views so numpy's subclass templating
        # (which would copy one arbitrary operand's epoch) never runs.
        plain = tuple(
            x.view(np.ndarray) if isinstance(x, WatermarkedArray) else x
            for x in inputs
        )
        out = kwargs.get("out")
        if out is not None:
            kwargs["out"] = tuple(
                o.view(np.ndarray) if isinstance(o, WatermarkedArray) else o
                for o in out
            )
        result = getattr(ufunc, method)(*plain, **kwargs)
        if result is NotImplemented:
            return NotImplemented

        def stamp(r, o):
            if o is not None and isinstance(o, WatermarkedArray):
                o.epoch = epoch  # in-place result: restamp the caller's array
                return o
            if isinstance(r, np.ndarray):
                r = r.view(WatermarkedArray)
                r.epoch = epoch
                return r
            return r  # scalar reductions stay plain python/numpy scalars

        outs = out if out is not None else (None,) * (
            len(result) if isinstance(result, tuple) else 1)
        if isinstance(result, tuple):
            return tuple(stamp(r, o) for r, o in zip(result, outs))
        return stamp(result, outs[0])


def _watermark(value, epoch: int):
    """Stamp a query reply with its epoch watermark (satellite: every
    CoreService reply must carry the epoch it was answered at)."""
    if isinstance(value, np.ndarray):
        out = value.view(WatermarkedArray)
        out.epoch = int(epoch)
        return out
    return Watermarked(int(value), epoch)


# ===================================================================== views
@dataclass(frozen=True)
class EpochView:
    """Immutable snapshot of the node state at one epoch.

    Holds only the O(n) in-memory arrays (read-only); every query below is a
    pure vectorized lookup with no edge-table I/O.
    """

    epoch: int
    core: np.ndarray  # (n,) int64, writeable=False
    deg: np.ndarray  # (n,) int64, writeable=False

    @property
    def n(self) -> int:
        return len(self.core)

    def coreness(self, v):
        """Core number of node ``v`` (int) or of an array of nodes."""
        if np.isscalar(v) or isinstance(v, (int, np.integer)):
            return int(self.core[int(v)])
        return self.core[np.asarray(v, dtype=np.int64)]

    def in_kcore(self, v, k: int):
        """Membership of ``v`` (scalar or array) in the k-core."""
        if np.isscalar(v) or isinstance(v, (int, np.integer)):
            return bool(self.core[int(v)] >= k)
        return self.core[np.asarray(v, dtype=np.int64)] >= k

    def kcore_members(self, k: int) -> np.ndarray:
        return np.flatnonzero(self.core >= k)

    def kcore_size(self, k: int) -> int:
        return int((self.core >= k).sum())

    def top_k(self, k: int) -> np.ndarray:
        """Node ids of the k highest-coreness nodes (ties: lower id first)."""
        n = self.n
        k = min(int(k), n)
        if k <= 0:
            return np.empty(0, dtype=np.int64)
        # partial-select then order, on a tie-free composite key
        # (coreness desc, node id asc): O(n + k log k)
        key = self.core * np.int64(n) - np.arange(n, dtype=np.int64)
        idx = np.argpartition(-key, k - 1)[:k]
        return idx[np.argsort(-key[idx])].astype(np.int64)

    def degeneracy(self) -> int:
        return int(self.core.max()) if self.n else 0

    def core_histogram(self) -> np.ndarray:
        """hist[c] = number of nodes with coreness exactly c."""
        return np.bincount(self.core, minlength=self.degeneracy() + 1)


# ===================================================================== stats
@dataclass
class BatchStats:
    """Per-batch admission + maintenance + I/O stats (DecompResult style)."""

    epoch: int
    num_requested: int
    num_dropped: int
    num_coalesced: int
    num_applied_deletes: int
    num_applied_inserts: int
    num_noops: int
    node_computations: int
    edge_block_reads: int
    node_table_reads: int
    iterations: int
    num_changed: int
    flushes: int
    wall_time_s: float
    # backpressure fields (stage-1 degradation): a deferred
    # batch was WAL-logged (durable) but coalesced into the pending pool
    # instead of applied; ``pending_updates`` is the pool size afterwards.
    deferred: bool = False
    pending_updates: int = 0


@dataclass
class RecoveryStats:
    """What recovery did, and what it cost vs. a cold decomposition."""

    snapshot_epoch: int
    recovered_epoch: int
    replayed_batches: int
    replayed_updates: int
    applied_deletes: int
    applied_inserts: int
    warm_restart: bool  # False => no WAL tail, snapshot state used as-is
    settle_node_computations: int = 0
    settle_iterations: int = 0
    settle_edge_block_reads: int = 0


class _LRUCache:
    """Tiny LRU for set-valued queries; cleared on every epoch publish."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()


# ============================================================== query surface
class QueryAPI:
    """The read side of the CQRS split: epoch-view queries + LRU memoization.

    Shared verbatim by the writer (``CoreWriter``) and the read replicas
    (``CoreReplica``): both publish immutable :class:`EpochView`s of their
    own O(n) node state and answer every query from the committed view, with
    every reply watermarked by the epoch it was answered at.  Requires the
    host object to provide ``self.epoch``, ``self.maintainer``, ``self.bg``
    and ``self.cache``; publishing calls :meth:`_publish_metrics` so each
    side exports its own gauges (writer epoch vs. replica epoch/lag).
    """

    def _publish(self) -> None:
        """Commit the current node state as the readable epoch view."""
        core = self.maintainer.core.copy()
        core.setflags(write=False)
        deg = np.asarray(self.bg.degrees(), dtype=np.int64)
        deg.setflags(write=False)
        self._view = EpochView(self.epoch, core, deg)
        self.cache.clear()
        self._publish_metrics()

    def _publish_metrics(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    # -------------------------------------------------------------- queries
    def view(self) -> EpochView:
        """The current committed epoch view (stable across later ingests)."""
        return self._view

    def coreness(self, v):
        t0 = time.perf_counter()
        view = self._view
        out = _watermark(view.coreness(v), view.epoch)
        self._query_done("coreness", t0)
        return out

    def in_kcore(self, v, k: int):
        t0 = time.perf_counter()
        view = self._view
        out = _watermark(view.in_kcore(v, k), view.epoch)
        self._query_done("in_kcore", t0)
        return out

    def kcore_members(self, k: int) -> np.ndarray:
        t0 = time.perf_counter()
        view = self._view
        key = (view.epoch, "kcore", int(k))
        out = self.cache.get(key)
        if out is None:
            out = view.kcore_members(k)
            out.setflags(write=False)  # hits are shared across callers
            self.cache.put(key, out)
        out = _watermark(out, view.epoch)
        self._query_done("kcore_members", t0)
        return out

    def top_k(self, k: int) -> np.ndarray:
        t0 = time.perf_counter()
        view = self._view
        key = (view.epoch, "topk", int(k))
        out = self.cache.get(key)
        if out is None:
            out = view.top_k(k)
            out.setflags(write=False)  # hits are shared across callers
            self.cache.put(key, out)
        out = _watermark(out, view.epoch)
        self._query_done("top_k", t0)
        return out

    def degeneracy(self) -> int:
        t0 = time.perf_counter()
        view = self._view
        out = _watermark(view.degeneracy(), view.epoch)
        self._query_done("degeneracy", t0)
        return out

    @staticmethod
    def _query_done(kind: str, t0: float) -> None:
        cnt, hist = _QOBS[kind]
        cnt.inc()
        hist.observe(time.perf_counter() - t0)

    def metrics(self) -> dict:
        """Observability endpoint: the process registry in both formats.

        ``json`` is the full structured dump (families, series, histogram
        buckets); ``prometheus`` is text exposition 0.0.4 ready to serve on a
        ``/metrics`` route.  Stamped with the committed epoch watermark so a
        scraper can correlate metric values with query replies.
        """
        reg = _metrics.get_registry()
        return {
            "epoch": self.epoch,
            "json": reg.to_dict(),
            "prometheus": reg.to_prometheus(),
        }


# ==================================================================== writer
class CoreWriter(QueryAPI):
    """Owns the semi-external node state and serves it under a live stream.

    ``backend`` selects the batch-settle compute substrate ("cuda" |
    "torch" | "numpy" | a ComputeBackend instance; ``None`` resolves
    ``REPRO_TORCH_BACKEND``, default "cuda") and ``device`` places it
    (``None``: cuda:0, raising without a GPU).  "numpy" keeps the paper's
    per-edge seq maintenance; a device backend ingests each batch through
    the grouped masked settle or one warm-started SemiCore* batch settle,
    device-resident: the settle's node state stays on the card across its
    passes, and the uploaded edge table is version-keyed on the long-lived
    maintainer, so a batch that turns out structure-free (all no-ops)
    re-uploads nothing.
    """

    def __init__(
        self,
        graph,
        *,
        block_edges: int = DEFAULT_BLOCK_EDGES,
        pool_blocks: int = 1,
        insert_algorithm: str = "semiinsert*",
        wal_path: str | None = None,
        wal_fsync: bool = False,
        snapshot_dir: str | None = None,
        snapshot_every: int = 0,
        snapshot_keep: int = 1,
        cache_size: int = 256,
        state: tuple[np.ndarray, np.ndarray] | None = None,
        epoch: int = 0,
        backend=None,
        superstep_chunk: int | None = None,
        retry=None,
        admission_budget: int = 0,
        admission_soft_ratio: float = 0.5,
        admission_max_defer: int = 4,
        settings=None,
        device=None,
    ):
        # ``settings`` is a repro_torch.runtime.Settings snapshot: one object
        # that carries every REPRO_TORCH_* knob through the service into the
        # maintainer (env vars still win per the env > override > default
        # order).
        self.maintainer = CoreMaintainer(
            graph, block_edges, state=state, pool_blocks=pool_blocks,
            backend=backend, superstep_chunk=superstep_chunk, retry=retry,
            settings=settings, device=device,
        )
        self.bg: BufferedGraph = self.maintainer.bg
        self.insert_algorithm = insert_algorithm
        self.epoch = int(epoch)
        #: the last WAL-durable epoch.  Without backpressure it equals
        #: ``epoch``; with an admission budget it can run ahead while
        #: accepted-but-deferred batches sit in the pending pool.
        self._wal_tip = int(epoch)
        self.wal = WriteAheadLog(wal_path, fsync=wal_fsync) if wal_path else None
        self.snapshots = (
            SnapshotStore(snapshot_dir, keep=snapshot_keep)
            if snapshot_dir else None)
        self.snapshot_every = int(snapshot_every)
        self.admission = (
            AdmissionController(
                admission_budget, soft_ratio=admission_soft_ratio,
                max_defer=admission_max_defer)
            if admission_budget > 0 else None)
        self._batches_since_snapshot = 0
        self.cache = _LRUCache(cache_size)
        self.batch_log: list[BatchStats] = []
        self._flush_events = 0
        self.bg.add_flush_hook(self._on_flush)
        self._publish()

    # ------------------------------------------------------------ internals
    def _on_flush(self, bg: BufferedGraph) -> None:
        # storage epoch turned over: the CSR was rewritten under the engine.
        # HostEngine re-points lazily on the next read, but the buffer pool
        # holds blocks of the *old* edge table — drop them now so a pooled
        # reader never serves stale hits across the rewrite.
        self._flush_events += 1
        self.maintainer.engine.reader.invalidate()

    def _publish_metrics(self) -> None:
        _EPOCH_GAUGE.set(self.epoch)
        _BUFFERED_GAUGE.set(self.bg._size)

    # --------------------------------------------------------------- writes
    def ingest(self, ops) -> BatchStats:
        """Admit + log + apply one micro-batch; commit a new epoch view.

        With an ``admission_budget`` configured, ingest degrades under load
        instead of queueing without bound: accepted batches are always
        WAL-logged (durable on accept) but may be *deferred* — coalesced
        into a bounded pending pool and applied as one settle later — and a
        batch that cannot fit even after a full drain is rejected with a
        typed :class:`Overloaded` (see backpressure.py for the state
        machine).
        """
        if self.admission is not None:
            return self._ingest_backpressure(ops)
        t0 = time.perf_counter()
        with _trace.span("service.ingest", cat="stream") as sp:
            admitted: AdmittedBatch = admit_batch(ops, n=self.bg.n)
            next_epoch = self.epoch + 1
            if self.wal is not None:  # write-ahead: log before touching state
                self.wal.append(next_epoch, admitted.batch)
            self._wal_tip = next_epoch
            flushes0 = self._flush_events
            m = self.maintainer.apply(
                admitted.batch, insert_algorithm=self.insert_algorithm
            )
            self.epoch = next_epoch
            self._publish()
            if sp.active:
                sp.set(epoch=next_epoch, requested=admitted.num_requested,
                       applied=m.num_deletes + m.num_inserts, noops=m.num_noops)
        _INGEST_SECONDS.observe(time.perf_counter() - t0)
        _INGESTS.inc()
        stats = BatchStats(
            epoch=self.epoch,
            num_requested=admitted.num_requested,
            num_dropped=admitted.num_dropped,
            num_coalesced=admitted.num_coalesced,
            num_applied_deletes=m.num_deletes,
            num_applied_inserts=m.num_inserts,
            num_noops=m.num_noops,
            node_computations=m.node_computations,
            edge_block_reads=m.edge_block_reads,
            node_table_reads=m.node_table_reads,
            iterations=m.iterations,
            num_changed=m.num_changed,
            flushes=self._flush_events - flushes0,
            wall_time_s=time.perf_counter() - t0,
        )
        self.batch_log.append(stats)
        self._batches_since_snapshot += 1
        if (
            self.snapshots is not None
            and self.snapshot_every > 0
            and self._batches_since_snapshot >= self.snapshot_every
        ):
            self.snapshot()
        return stats

    def _ingest_backpressure(self, ops) -> BatchStats:
        """Budgeted ingest: accept-durably, coalesce, defer, drain or shed.

        Order of operations per offer: (1) a batch larger than the whole
        budget can never fit and is shed immediately; (2) if the pool plus
        the incoming batch overflows, the pool is drained first — after
        which the batch fits by (1); (3) the accepted batch is WAL-appended
        at ``_wal_tip + 1`` (durable even if deferred) and merged into the
        pool; (4) the controller decides apply-now vs. defer (bounded by
        ``max_defer`` consecutive deferrals).
        """
        adm = self.admission
        t0 = time.perf_counter()
        with _trace.span("service.ingest", cat="stream") as sp:
            admitted: AdmittedBatch = admit_batch(ops, n=self.bg.n)
            incoming = admitted.num_admitted
            if incoming > adm.budget:
                raise adm.reject(incoming)
            if not adm.fits(incoming):
                self._apply_pending()  # stage-2 pressure: drain restores room
            next_tip = self._wal_tip + 1
            if self.wal is not None:  # durable on accept, even when deferred
                self.wal.append(next_tip, admitted.batch)
            self._wal_tip = next_tip
            adm.merge(admitted.deletes, admitted.inserts)
            if adm.should_apply():
                stats = self._apply_pending(admitted=admitted, t0=t0)
            else:
                adm.note_deferred()
                stats = BatchStats(
                    epoch=self.epoch,
                    num_requested=admitted.num_requested,
                    num_dropped=admitted.num_dropped,
                    num_coalesced=admitted.num_coalesced,
                    num_applied_deletes=0, num_applied_inserts=0,
                    num_noops=0, node_computations=0, edge_block_reads=0,
                    node_table_reads=0, iterations=0, num_changed=0,
                    flushes=0, wall_time_s=time.perf_counter() - t0,
                    deferred=True, pending_updates=adm.pending_updates,
                )
            if sp.active:
                sp.set(epoch=self.epoch, wal_tip=self._wal_tip,
                       requested=admitted.num_requested,
                       deferred=stats.deferred,
                       pending=adm.pending_updates)
        _INGEST_SECONDS.observe(time.perf_counter() - t0)
        _INGESTS.inc()
        self.batch_log.append(stats)
        self._batches_since_snapshot += 1
        if (
            self.snapshots is not None
            and self.snapshot_every > 0
            and self._batches_since_snapshot >= self.snapshot_every
        ):
            self.snapshot()
        return stats

    def _apply_pending(self, admitted: AdmittedBatch | None = None,
                       t0: float | None = None) -> BatchStats:
        """Drain the whole pending pool into one settle at ``_wal_tip``.

        All-or-nothing by design: the published view must equal the state a
        replica reaches by replaying WAL records 1..``_wal_tip`` one at a
        time, which coalesced last-op-per-edge application guarantees (see
        backpressure.py).  Safe to call with an empty pool (publishes the
        current state at the tip epoch).
        """
        adm = self.admission
        t0 = time.perf_counter() if t0 is None else t0
        deletes, inserts = adm.take()
        pending = UpdateBatch.from_pairs(deletes, inserts)
        flushes0 = self._flush_events
        ta = time.perf_counter()
        m = self.maintainer.apply(pending,
                                  insert_algorithm=self.insert_algorithm)
        adm.note_applied(len(pending), time.perf_counter() - ta)
        self.epoch = self._wal_tip
        self._publish()
        stats = BatchStats(
            epoch=self.epoch,
            num_requested=admitted.num_requested if admitted else 0,
            num_dropped=admitted.num_dropped if admitted else 0,
            num_coalesced=admitted.num_coalesced if admitted else 0,
            num_applied_deletes=m.num_deletes,
            num_applied_inserts=m.num_inserts,
            num_noops=m.num_noops,
            node_computations=m.node_computations,
            edge_block_reads=m.edge_block_reads,
            node_table_reads=m.node_table_reads,
            iterations=m.iterations,
            num_changed=m.num_changed,
            flushes=self._flush_events - flushes0,
            wall_time_s=time.perf_counter() - t0,
            pending_updates=0,
        )
        return stats

    # --------------------------------------------------------------- health
    def health(self) -> dict:
        """Liveness/degradation summary: {status, epoch, wal lag, admission}.

        ``status`` is "ok", "degraded" (deferred batches pending — readers
        see a bounded-stale epoch) or "overloaded" (recent shedding with a
        still-saturated pool).
        """
        status = "ok"
        out = {
            "epoch": int(self.epoch),
            "wal_tip": int(self._wal_tip),
            "wal_lag": int(self._wal_tip - self.epoch),
            "wal_appends": self.wal.appends if self.wal else 0,
        }
        if self.admission is not None:
            adm_state = self.admission.state()
            out["admission"] = adm_state
            if adm_state["stage"] == "overloaded" or (
                    adm_state["stage"] == "degraded"
                    and adm_state["pending_updates"] >= self.admission.budget):
                status = "overloaded"
            elif adm_state["stage"] == "degraded" or out["wal_lag"] > 0:
                status = "degraded"
        out["status"] = status
        return out

    def snapshot(self) -> None:
        """Flush the update buffer and atomically dump the durable state.

        Snapshot publish also rotates the WAL: records at or below the
        *rotation floor* are superseded and would otherwise grow the log
        without bound.  The floor is the oldest **retained** snapshot's
        epoch (``SnapshotStore.oldest_retained_epoch``): with the default
        ``keep=1`` that is the snapshot just published (the historical
        behavior), while ``keep >= 2`` keeps enough WAL tail to roll forward
        from the older fallback snapshots, making recover-from-previous-
        snapshot sound when the newest one turns out corrupt.  Rotation is
        atomic (stream the tail to a temp file + rename + dir fsync) and
        ordered *after* the snapshot publish, so a crash between the two
        leaves a WAL that is merely longer than necessary, never one missing
        records the latest snapshot doesn't cover.
        """
        if self.snapshots is None:
            raise RuntimeError("CoreService was built without a snapshot_dir")
        if self.admission is not None and (
                self.admission.pending or self.epoch != self._wal_tip):
            # the snapshot must capture a state that equals a WAL prefix
            self._apply_pending()
        g = self.bg.materialize()
        self.snapshots.save(self.epoch, g, self.maintainer.core, self.maintainer.cnt)
        if self.wal is not None:
            floor = self.snapshots.oldest_retained_epoch()
            self.wal.rotate(self.epoch if floor is None else floor)
        self._batches_since_snapshot = 0

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()

    # ---------------------------------------------------------------- stats
    def service_stats(self) -> dict:
        reader = self.maintainer.engine.reader
        return {
            "epoch": self.epoch,
            "backend": self.maintainer.backend.name,
            "n": self.bg.n,
            "m": self.bg.m,
            "degeneracy": self.degeneracy(),
            "batches": len(self.batch_log),
            "updates_applied": sum(
                s.num_applied_deletes + s.num_applied_inserts for s in self.batch_log
            ),
            "edge_block_reads_total": reader.reads,
            "edge_block_hits_total": reader.hits,
            "pool_blocks": reader.pool_blocks,
            "node_table_reads_total": reader.node_table_reads,
            "flush_events": self._flush_events,
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "wal_appends": self.wal.appends if self.wal else 0,
            # device-backend settles only: edge-table uploads (cache misses
            # of the version-keyed resident structure)
            "backend_structure_builds": getattr(
                self.maintainer.backend, "structure_builds", 0),
        }

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(
        cls,
        *,
        wal_path: str | None = None,
        snapshot_dir: str | None = None,
        base_graph: CSRGraph | None = None,
        block_edges: int = DEFAULT_BLOCK_EDGES,
        pool_blocks: int = 1,
        snapshot_keep: int = 1,
        **service_kwargs,
    ) -> tuple["CoreService", RecoveryStats]:
        """Rebuild a service from snapshot + WAL tail, without full recompute.

        The warm restart leans on convergence-from-above (Thm 4.1): with the
        WAL tail replayed structurally, ``min(snapshot_core + I, deg)`` — I
        the number of net-inserted tail edges, since one insertion raises any
        core by at most one and deletions never raise it — is a pointwise
        upper bound of the true decomposition, so SemiCore* passes from it
        (with ``cnt`` recomputed exactly once) settle to the exact fixpoint.

        Corruption handling: a corrupt snapshot falls back
        to an older retained one inside ``SnapshotStore.latest``; a framed
        WAL record that fails its checksum ends the replay at that record —
        the intact prefix is kept, the log is truncated at the corruption
        offset (those batches are lost, exactly as if the crash had happened
        before them), and the writer resumes from the last good epoch.
        """
        snap = (SnapshotStore(snapshot_dir, keep=snapshot_keep).latest()
                if snapshot_dir else None)
        if snap is not None:
            epoch0, g, core0, cnt0 = snap
        elif base_graph is not None:
            epoch0, g, core0, cnt0 = 0, base_graph, None, None
        else:
            raise ValueError("recover() needs a snapshot_dir with a snapshot "
                             "or a base_graph")

        bg = BufferedGraph(g)
        applied_d = applied_i = batches = updates = 0
        last_epoch = epoch0
        if wal_path is not None:
            replay = WriteAheadLog.replay(wal_path, after_epoch=epoch0)
            while True:
                try:
                    e, batch = next(replay)
                except StopIteration:
                    break
                except CorruptionError as err:
                    # keep the intact prefix; amputate the log at the bad
                    # record so the reopened WAL appends after good data.
                    if err.offset is not None and os.path.exists(wal_path):
                        with open(wal_path, "rb+") as f:
                            f.truncate(err.offset)
                    break
                batches += 1
                updates += len(batch)
                for op in batch:  # structural replay, in WAL op order
                    if isinstance(op, Delete):
                        applied_d += bool(bg.delete_edge(int(op.u), int(op.v)))
                    else:
                        applied_i += bool(bg.insert_edge(int(op.u), int(op.v)))
                last_epoch = max(last_epoch, e)

        state = None
        settle = None
        warm_restart = False
        if core0 is not None:
            if applied_d or applied_i:
                warm_restart = True
                bg.flush()  # one CSR rewrite so the settle scans exact lists
                # the settle's backend and chunk as the writer's maintainer
                # resolves them: arguments, then settings, then the knobs
                settings = service_kwargs.get("settings")
                backend = service_kwargs.get("backend")
                chunk = service_kwargs.get("superstep_chunk")
                if settings is not None:
                    if backend is None:
                        backend = settings.backend
                    if chunk is None:
                        chunk = settings.resident_chunk
                eng = HostEngine(bg, block_edges, pool_blocks=pool_blocks,
                                 retry=service_kwargs.get("retry"),
                                 settings=settings)
                settle = warm_settle(eng, core0, applied_i, backend,
                                     superstep_chunk=chunk,
                                     device=service_kwargs.get("device"))
                state = (settle.core, settle.cnt)
            else:
                state = (core0, cnt0)

        svc = cls(
            bg,
            block_edges=block_edges,
            pool_blocks=pool_blocks,
            wal_path=wal_path,
            snapshot_dir=snapshot_dir,
            snapshot_keep=snapshot_keep,
            state=state,
            epoch=last_epoch,
            **service_kwargs,
        )
        stats = RecoveryStats(
            snapshot_epoch=epoch0,
            recovered_epoch=last_epoch,
            replayed_batches=batches,
            replayed_updates=updates,
            applied_deletes=applied_d,
            applied_inserts=applied_i,
            warm_restart=warm_restart,
            settle_node_computations=settle.node_computations if settle else 0,
            settle_iterations=settle.iterations if settle else 0,
            settle_edge_block_reads=settle.edge_block_reads if settle else 0,
        )
        return svc, stats


#: Established name of the writer.  In a single-process deployment the
#: writer serves both roles of the CQRS split, so the historical service
#: name stays bound to it; replicated deployments pair one ``CoreWriter``
#: with N ``CoreReplica``s (replica.py).
CoreService = CoreWriter
