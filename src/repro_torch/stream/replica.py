"""CoreReplica: the read side of the CQRS split — WAL-tailing read replicas.

The paper's semi-external contract makes the serving process cheap to
replicate: a replica needs only the O(n) node arrays and the writer's WAL
tail, never a second copy of the edge-table machinery's write path.  A
``CoreReplica``

* **bootstraps** from ``SnapshotStore.latest()`` + a *structural* replay of
  the WAL tail, settled with one warm SemiCore* pass — exactly the
  recovery discipline of ``CoreService.recover``, so the
  replica's ``(core, cnt)`` lands on the writer's exact fixpoint;
* **tails** the WAL incrementally with :class:`~.wal.WalTailer` (byte-offset
  cursor, complete-records-only, rotation-aware), replaying each admitted
  batch through its own ``CoreMaintainer.apply`` — the same exact
  maintenance the writer ran — and publishing an :class:`EpochView` per
  batch.  Per-node core views converge correctly under asynchronous,
  replayed update orders (Montresor et al., arXiv 1103.5320); here the
  replay order *is* the writer's commit order, so every replica epoch is
  bit-identical to the writer's state at that epoch;
* **serves** the full ``QueryAPI`` (coreness / in_kcore / kcore_members /
  top_k / degeneracy) from its own epoch views, every reply watermarked
  with the replica's committed epoch, with ``lag()`` exposing staleness as
  (writer WAL tip epoch − replica epoch);
* **catches up restartably**: if a rotation outruns the tailer
  (:class:`~.wal.WalGap`), the replica re-bootstraps from the latest
  snapshot — the same snapshot + tail path, incremental and restartable.

Replica-side telemetry: ``repro_replica_epoch`` /
``repro_replica_lag`` gauges and a lag histogram per replica id; the
per-kind query series of service.py are reused, so a dashboard sees one
query-latency family across writer and replicas.

The port's own copy of ``repro/stream/replica.py``; ``backend``/``device``
place the bootstrap's warm settle and the tailing maintainer as on the
writer (``None``: "cuda" on cuda:0, raising without a GPU).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from ..core.engine import warm_settle
from ..core.maintenance import CoreMaintainer
from ..core.semicore import HostEngine
from ..core.update import Delete
from ..faults import CircuitBreaker
from ..graph.storage import DEFAULT_BLOCK_EDGES
from ..graph.updates import BufferedGraph
from ..obs import metrics as _metrics, trace as _trace
from .service import EpochView, QueryAPI, _LRUCache
from .wal import CorruptionError, SnapshotStore, WalGap, WalTailer, WriteAheadLog

__all__ = ["CoreReplica", "BootstrapStats"]

_REPLICA_EPOCH = _metrics.gauge(
    "repro_replica_epoch", "Replica committed epoch watermark")
_REPLICA_LAG = _metrics.gauge(
    "repro_replica_lag",
    "Replica staleness: writer WAL tip epoch minus replica epoch")
_REPLICA_LAG_EPOCHS = _metrics.histogram(
    "repro_replica_lag_epochs",
    "Observed replica lag (epochs) at each lag() probe",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS)
_REPLICA_BATCHES = _metrics.counter(
    "repro_replica_batches_applied_total",
    "WAL batches replayed into replica epoch views")
_REPLICA_SYNC_SECONDS = _metrics.histogram(
    "repro_replica_sync_seconds", "Replica sync() latency (tail + apply)")
_REPLICA_BOOTSTRAPS = _metrics.counter(
    "repro_replica_bootstraps_total",
    "Replica bootstraps (snapshot + structural tail replay + warm settle); "
    "first one is construction, later ones are WalGap catch-ups")
_REPLICA_SYNC_FAILURES = _metrics.counter(
    "repro_replica_sync_failures_total",
    "sync() attempts that failed (transient I/O, gap, or corruption) and "
    "left the replica serving its last good epoch")


@dataclass
class BootstrapStats:
    """What one bootstrap (construction or WalGap catch-up) did."""

    snapshot_epoch: int
    bootstrapped_epoch: int
    replayed_batches: int
    replayed_updates: int
    applied_deletes: int
    applied_inserts: int
    warm_restart: bool  # False => no WAL tail, snapshot state used as-is
    settle_node_computations: int = 0
    settle_iterations: int = 0


class CoreReplica(QueryAPI):
    """Serves the query surface from WAL-replayed epoch views.

    A replica never writes: it owns no WAL handle and no snapshot publisher,
    only a :class:`WalTailer` cursor over the writer's log and its own
    ``CoreMaintainer`` holding the O(n) node state.  ``sync()`` drains newly
    durable batches; every committed batch publishes a fresh immutable
    ``EpochView`` (the last ``keep_views`` are retained so a reader can pin
    a recent epoch), and queries answer from the newest one, watermarked.
    """

    def __init__(
        self,
        *,
        snapshot_dir: str,
        wal_path: str,
        block_edges: int = DEFAULT_BLOCK_EDGES,
        pool_blocks: int = 1,
        insert_algorithm: str = "semiinsert*",
        backend=None,
        superstep_chunk: int | None = None,
        cache_size: int = 256,
        replica_id: int = 0,
        keep_views: int = 4,
        retry=None,
        breaker_trip_after: int = 3,
        device=None,
    ):
        self.snapshots = SnapshotStore(snapshot_dir)
        self.wal_path = wal_path
        self.block_edges = int(block_edges)
        self.pool_blocks = int(pool_blocks)
        self.insert_algorithm = insert_algorithm
        self._backend = backend
        self._superstep_chunk = superstep_chunk
        self._device = device
        self.replica_id = int(replica_id)
        self.keep_views = max(int(keep_views), 1)
        self.retry = retry  # optional faults.RetryPolicy for polls/loads
        self.breaker = CircuitBreaker(trip_after=breaker_trip_after)
        self.stale_serving = False  # last sync/bootstrap failed: views frozen
        self.sync_failures = 0
        self.bootstrap_failures = 0
        self.cache = _LRUCache(cache_size)
        self.views: list[EpochView] = []  # newest last, bounded chain
        self.bootstraps = 0
        self.batches_applied = 0
        self.last_bootstrap: BootstrapStats | None = None
        _lbl = {"replica": str(self.replica_id)}
        self._epoch_gauge = _REPLICA_EPOCH.labels(**_lbl)
        self._lag_gauge = _REPLICA_LAG.labels(**_lbl)
        self._lag_hist = _REPLICA_LAG_EPOCHS.labels(**_lbl)
        self._batches_ctr = _REPLICA_BATCHES.labels(**_lbl)
        self._sync_hist = _REPLICA_SYNC_SECONDS.labels(**_lbl)
        self._bootstraps_ctr = _REPLICA_BOOTSTRAPS.labels(**_lbl)
        self._sync_failures_ctr = _REPLICA_SYNC_FAILURES.labels(**_lbl)
        self._bootstrap()

    # ------------------------------------------------------------ bootstrap
    def _bootstrap(self) -> None:
        """Snapshot + structural WAL-tail replay + warm settle (restartable).

        This *is* the catch-up protocol: a fresh replica, a replica that
        fell behind a rotation, and writer crash recovery all walk the same
        path.  A rotation racing the bootstrap (newer snapshot published
        between ``latest()`` and the tail replay) surfaces as a
        :class:`WalGap` and simply restarts the bootstrap against the newer
        snapshot.
        """
        with _trace.span("replica.bootstrap", cat="stream",
                         replica=self.replica_id):
            for _ in range(3):  # rotation races are resolved by retrying
                try:
                    self._bootstrap_once()
                    break
                except WalGap:
                    continue
            else:
                raise RuntimeError(
                    "replica bootstrap kept losing rotation races; "
                    "is the writer snapshotting every batch?")
        self.bootstraps += 1
        self._bootstraps_ctr.inc()
        self._publish()
        self.lag()

    def _bootstrap_once(self) -> None:
        if self.retry is None:
            snap = self.snapshots.latest()
        else:  # transient load failures retry; CorruptionError falls through
            snap = self.retry.call(self.snapshots.latest, op="snapshot.load",
                                   retry_on=(OSError,))
        if snap is None:
            raise RuntimeError(
                "CoreReplica needs a published snapshot to bootstrap from; "
                "call writer.snapshot() first")
        epoch0, g, core0, cnt0 = snap
        bg = BufferedGraph(g)
        tailer = WalTailer(self.wal_path, after_epoch=epoch0)
        applied_d = applied_i = batches = updates = 0
        last_epoch = epoch0
        try:
            for e, batch in tailer.poll():
                batches += 1
                updates += len(batch)
                for op in batch:  # structural replay, in WAL op order
                    if isinstance(op, Delete):
                        applied_d += bool(bg.delete_edge(int(op.u), int(op.v)))
                    else:
                        applied_i += bool(bg.insert_edge(int(op.u), int(op.v)))
                last_epoch = e
        except CorruptionError:
            # a corrupt record past the snapshot: bring the replica up on
            # the intact prefix instead of failing construction.  The
            # cursor is pinned before the bad record, so the next sync()
            # re-detects it and escalates (bootstrap / wait for the
            # writer's rotation to repair the log).
            pass
        settle = None
        if applied_d or applied_i:
            bg.flush()  # one CSR rewrite so the settle scans exact lists
            eng = HostEngine(bg, self.block_edges, pool_blocks=self.pool_blocks,
                             retry=self.retry)
            settle = warm_settle(eng, core0, applied_i, self._backend,
                                 superstep_chunk=self._superstep_chunk,
                                 device=self._device)
            state = (settle.core, settle.cnt)
        else:
            state = (core0, cnt0)
        self.maintainer = CoreMaintainer(
            bg, self.block_edges, state=state, pool_blocks=self.pool_blocks,
            backend=self._backend, superstep_chunk=self._superstep_chunk,
            retry=self.retry, device=self._device,
        )
        self.bg = self.maintainer.bg
        self.epoch = last_epoch
        self.tailer = tailer
        self.last_bootstrap = BootstrapStats(
            snapshot_epoch=epoch0,
            bootstrapped_epoch=last_epoch,
            replayed_batches=batches,
            replayed_updates=updates,
            applied_deletes=applied_d,
            applied_inserts=applied_i,
            warm_restart=settle is not None,
            settle_node_computations=settle.node_computations if settle else 0,
            settle_iterations=settle.iterations if settle else 0,
        )

    # ----------------------------------------------------------- publishing
    def _publish(self) -> None:
        super()._publish()
        self.views.append(self._view)
        del self.views[:-self.keep_views]

    def _publish_metrics(self) -> None:
        self._epoch_gauge.set(self.epoch)

    def view_at(self, epoch: int) -> EpochView:
        """A retained view at exactly ``epoch`` (KeyError when evicted)."""
        for v in self.views:
            if v.epoch == epoch:
                return v
        raise KeyError(
            f"epoch {epoch} not retained (have "
            f"{[v.epoch for v in self.views]})")

    # ----------------------------------------------------------------- sync
    def _drain(self, max_batches: int | None) -> int:
        """One tailing pass: apply newly durable records from the cursor.

        Idempotent under retry: the cursor (byte offset + last epoch)
        advances only past records that were fully applied, so re-calling
        after a transient failure resumes exactly where the failure struck.
        """
        applied = 0
        for e, batch in self.tailer.poll():
            self.maintainer.apply(batch,
                                  insert_algorithm=self.insert_algorithm)
            self.epoch = e
            self.batches_applied += 1
            self._batches_ctr.inc()
            applied += 1
            self._publish()
            if max_batches is not None and applied >= max_batches:
                break
        return applied

    def _recover_by_bootstrap(self) -> int:
        """Full snapshot catch-up after tailing broke (gap/corruption/trip).

        On failure the replica *keeps serving* its last good epoch views
        (``stale_serving`` flips on, the failure is counted) instead of
        raising into the read path — staleness is visible through
        ``health()``/``lag()``, availability is preserved.
        """
        try:
            if self.retry is None:
                self._bootstrap()
            else:
                self.retry.call(self._bootstrap, op="replica.bootstrap",
                                retry_on=(OSError,))
        except (OSError, CorruptionError, RuntimeError):
            self.stale_serving = True
            self.bootstrap_failures += 1
            self._sync_failures_ctr.inc()
            return 0
        self.breaker.record_success()
        self.stale_serving = False
        return 1

    def sync(self, max_batches: int | None = None) -> int:
        """Drain newly durable WAL records into the epoch-view chain.

        Replays each batch through ``CoreMaintainer.apply`` — the
        writer's own maintenance path, so the settled ``(core, cnt)`` is
        bit-identical to the writer's at the same epoch — and publishes one
        ``EpochView`` per batch.  Returns the number of batches applied
        (bootstrap counts as one).

        Failure policy: falling behind a rotation
        (:class:`WalGap`) or hitting a checksum failure
        (:class:`CorruptionError`) abandons incremental tailing for a full
        snapshot bootstrap; transient I/O errors are retried by the
        configured ``RetryPolicy`` and, when they persist, counted by the
        circuit breaker — ``breaker_trip_after`` consecutive failed syncs
        trip straight to bootstrap.  Every failure path degrades to serving
        the last good epoch rather than raising into the read path.
        """
        t0 = time.perf_counter()
        applied = 0
        with _trace.span("replica.sync", cat="stream",
                         replica=self.replica_id) as sp:
            try:
                if self.retry is None:
                    applied = self._drain(max_batches)
                else:
                    applied = self.retry.call(
                        self._drain, max_batches, op="replica.sync",
                        retry_on=(OSError,))
                self.breaker.record_success()
                self.stale_serving = False
                if applied == 0:
                    # an empty drain with a newer snapshot published means
                    # the log has nothing left for this cursor (a rotation
                    # repaired records away, or emptied the log entirely):
                    # the snapshot store is the only way forward.
                    floor = self.snapshots.latest_epoch()
                    if floor is not None and floor > self.epoch:
                        applied += self._recover_by_bootstrap()
            except (WalGap, CorruptionError):
                # non-transient: the log no longer works for this cursor
                self.sync_failures += 1
                applied += self._recover_by_bootstrap()
            except OSError:
                # transient (possibly injected): serve stale, let the
                # breaker decide when banging on the WAL stops being useful
                self.sync_failures += 1
                self._sync_failures_ctr.inc()
                self.stale_serving = True
                if self.breaker.record_failure():
                    applied += self._recover_by_bootstrap()
            if sp.active:
                sp.set(applied=applied, epoch=self.epoch,
                       stale=self.stale_serving)
        self._sync_hist.observe(time.perf_counter() - t0)
        self.lag()
        return applied

    # --------------------------------------------------------------- health
    def health(self) -> dict:
        """Replica liveness summary: {status, epoch, lag, breaker state}.

        ``status`` is "ok" when tailing normally and "degraded" while the
        replica serves stale views (failed sync/bootstrap or a tripped
        breaker); a replica is never "overloaded" — it sheds nothing.
        """
        lag = self.lag()
        degraded = self.stale_serving or self.breaker.tripped
        return {
            "status": "degraded" if degraded else "ok",
            "replica_id": self.replica_id,
            "epoch": int(self.epoch),
            "lag": int(lag),
            "stale_serving": self.stale_serving,
            "breaker": {
                "tripped": self.breaker.tripped,
                "consecutive_failures": self.breaker.consecutive_failures,
                "trips": self.breaker.trips,
            },
            "sync_failures": self.sync_failures,
            "bootstrap_failures": self.bootstrap_failures,
            "bootstraps": self.bootstraps,
        }

    # ------------------------------------------------------------ staleness
    def lag(self, writer_epoch: int | None = None) -> int:
        """Epochs this replica trails the writer (0 = fully caught up).

        With ``writer_epoch`` given, that is the authority; otherwise the
        writer's committed tip is read from the WAL's last complete record
        (an O(record) backwards peek — the WAL is append-before-apply, so
        its tip bounds the writer's committed epoch from above by at most
        the one in-flight batch), floored by the latest snapshot's epoch:
        right after a rotation the WAL can be empty, but the snapshot that
        triggered the rotation pins the writer's epoch from below.
        """
        if writer_epoch is None:
            tip = WriteAheadLog.tip_epoch(self.wal_path)
            snap = self.snapshots.latest_epoch()
            writer_epoch = max(
                x for x in (tip, snap, self.epoch) if x is not None)
        out = max(0, int(writer_epoch) - int(self.epoch))
        self._lag_gauge.set(out)
        self._lag_hist.observe(out)
        return out

    # ---------------------------------------------------------------- stats
    def replica_stats(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "epoch": self.epoch,
            "lag": self.lag(),
            "n": self.bg.n,
            "m": self.bg.m,
            "batches_applied": self.batches_applied,
            "bootstraps": self.bootstraps,
            "sync_failures": self.sync_failures,
            "bootstrap_failures": self.bootstrap_failures,
            "stale_serving": self.stale_serving,
            "rotations_detected": self.tailer.rotations_detected,
            "wal_records_read": self.tailer.records_read,
            "retained_views": [v.epoch for v in self.views],
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "backend": self.maintainer.backend.name,
        }
