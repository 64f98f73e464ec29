"""Admission backpressure for the CoreWriter.

The port's own copy of ``repro/stream/backpressure.py``, on the port's
gauges.

The writer's ingest is synchronous, so overload does not show up as a full
queue — it shows up as callers outrunning the settle rate.  The
:class:`AdmissionController` bounds the damage with a pending-updates
budget and three-stage degradation:

* **ok** (stage 0, ``pending <= soft``) — every accepted batch is applied
  immediately; normal operation;
* **degraded** (stage 1, ``soft < pending <= budget``) — accepted batches
  are WAL-logged (durable on accept) but *deferred*: they coalesce into the
  pending pool (last-op-per-edge wins, so N batches against the same hot
  edges collapse) and are applied as one settle.  Staleness is bounded: at
  most ``max_defer`` consecutive ingests defer before a forced drain;
* **overloaded** (stage 2) — an incoming batch that cannot fit even after a
  full drain is rejected with a typed :class:`Overloaded` carrying a
  ``retry_after_s`` estimated from the recent apply throughput.

Why coalesced deferral is *safe*: per-edge last-op-wins makes the pending
pool's net structural effect identical to applying the same records one at
a time, and the exact decomposition is a pure function of the graph — so
when the writer drains at WAL epoch k its (core, cnt) is bit-identical to a
replica that replayed records 1..k individually (Li & Yu's bounded
per-update change sets are what keep the drained settle cheap).
"""
from __future__ import annotations

from ..obs import metrics as _metrics

__all__ = ["Overloaded", "AdmissionController"]

_BP_STATE = _metrics.gauge(
    "repro_backpressure_state",
    "Admission degradation stage: 0=ok, 1=degraded, 2=overloaded").labels()
_BP_PENDING = _metrics.gauge(
    "repro_backpressure_pending_updates",
    "Coalesced structural updates accepted but not yet applied").labels()
_BP_REJECTED = _metrics.counter(
    "repro_backpressure_rejected_total",
    "Update offers rejected with Overloaded").labels()
_BP_DEFERRED = _metrics.counter(
    "repro_backpressure_deferred_batches_total",
    "Accepted batches deferred into the pending pool (bounded staleness)"
).labels()
_BP_COALESCED = _metrics.counter(
    "repro_backpressure_coalesced_total",
    "Pending-pool merges where an edge already had a pending op").labels()

_STAGES = ("ok", "degraded", "overloaded")


class Overloaded(RuntimeError):
    """The writer shed an update batch: the admission budget is exhausted.

    ``retry_after_s`` is the controller's estimate (from recent apply
    throughput) of when enough budget will have drained; callers should
    back off at least that long before re-offering.
    """

    def __init__(self, *, requested: int, pending: int, budget: int,
                 retry_after_s: float):
        super().__init__(
            f"admission budget exhausted: {requested} offered, {pending} "
            f"pending of {budget} budget; retry after {retry_after_s:.3f}s")
        self.requested = requested
        self.pending = pending
        self.budget = budget
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Bounded pending-updates pool with staged degradation (module doc).

    ``budget`` is the hard cap on coalesced pending updates; ``soft_ratio``
    sets the degraded-stage threshold; ``max_defer`` bounds how many
    consecutive ingests may defer before the owner must drain (the
    bounded-staleness knob).
    """

    def __init__(self, budget: int, *, soft_ratio: float = 0.5,
                 max_defer: int = 4):
        if budget < 1:
            raise ValueError("admission budget must be >= 1")
        self.budget = int(budget)
        self.soft = max(1, int(self.budget * float(soft_ratio)))
        self.max_defer = max(1, int(max_defer))
        self.pending: dict[tuple[int, int], str] = {}  # edge -> "+" | "-"
        self.deferred_batches = 0  # consecutive, reset on drain
        self.rejected_batches = 0
        self.rejected_updates = 0
        self.coalesced = 0
        self._rate_ewma = 0.0  # applied updates / second
        self._sync_gauges()

    # ------------------------------------------------------------------ state
    @property
    def pending_updates(self) -> int:
        return len(self.pending)

    def stage(self) -> str:
        if len(self.pending) > self.budget:
            return "overloaded"
        if len(self.pending) > self.soft:
            return "degraded"
        return "ok"

    def _sync_gauges(self) -> None:
        _BP_STATE.set(_STAGES.index(self.stage()))
        _BP_PENDING.set(len(self.pending))

    # ------------------------------------------------------------- decisions
    def fits(self, incoming: int) -> bool:
        """Can ``incoming`` coalesced updates join the pool right now?"""
        return len(self.pending) + incoming <= self.budget

    def should_apply(self) -> bool:
        """Drain now?  Stage 0 applies immediately; stage 1 defers until the
        bounded-staleness window (``max_defer`` consecutive deferrals) is
        spent."""
        return (len(self.pending) <= self.soft
                or self.deferred_batches >= self.max_defer)

    # ------------------------------------------------------------ transitions
    def merge(self, deletes, inserts) -> int:
        """Coalesce one admitted batch into the pool; returns new merges."""
        pending = self.pending
        coalesced = 0
        for u, v in deletes:
            key = (int(u), int(v))
            coalesced += key in pending
            pending[key] = "-"
        for u, v in inserts:
            key = (int(u), int(v))
            coalesced += key in pending
            pending[key] = "+"
        if coalesced:
            self.coalesced += coalesced
            _BP_COALESCED.inc(coalesced)
        self._sync_gauges()
        return coalesced

    def note_deferred(self) -> None:
        self.deferred_batches += 1
        _BP_DEFERRED.inc()
        self._sync_gauges()

    def take(self) -> tuple[list, list]:
        """All-or-nothing drain: the whole pool becomes one applied batch.

        Partial drains would publish an epoch whose state matches no WAL
        prefix; taking everything keeps every published epoch bit-identical
        to a replica that replayed the same records individually.
        """
        deletes = [e for e, kind in self.pending.items() if kind == "-"]
        inserts = [e for e, kind in self.pending.items() if kind == "+"]
        self.pending.clear()
        self.deferred_batches = 0
        self._sync_gauges()
        return deletes, inserts

    def note_applied(self, count: int, seconds: float) -> None:
        """Feed the apply-throughput EWMA that prices ``retry_after_s``."""
        if count <= 0:
            return
        rate = count / max(seconds, 1e-6)
        self._rate_ewma = (
            rate if self._rate_ewma == 0.0
            else 0.3 * rate + 0.7 * self._rate_ewma)

    def reject(self, requested: int) -> Overloaded:
        """Record a shed batch and build the typed rejection to raise."""
        self.rejected_batches += 1
        self.rejected_updates += requested
        _BP_REJECTED.inc()
        exc = Overloaded(
            requested=requested, pending=len(self.pending),
            budget=self.budget, retry_after_s=self.retry_after(requested))
        self._sync_gauges()
        return exc

    def retry_after(self, incoming: int) -> float:
        """Seconds until ``incoming`` should fit, from the apply EWMA."""
        backlog = max(0, len(self.pending) + incoming - self.soft)
        if self._rate_ewma <= 0.0:
            return 0.05  # no throughput signal yet: a polite default
        return min(60.0, max(0.01, backlog / self._rate_ewma))

    # ------------------------------------------------------------------ intro
    def state(self) -> dict:
        return {
            "stage": self.stage(),
            "pending_updates": len(self.pending),
            "budget": self.budget,
            "soft_budget": self.soft,
            "deferred_batches": self.deferred_batches,
            "max_defer": self.max_defer,
            "rejected_batches": self.rejected_batches,
            "rejected_updates": self.rejected_updates,
            "coalesced": self.coalesced,
            "apply_rate_ewma": self._rate_ewma,
        }
