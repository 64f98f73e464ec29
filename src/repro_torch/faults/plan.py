"""Seeded, scriptable fault schedules.

The port's own copy of ``repro/faults/plan.py``.  A :class:`FaultPlan`
decides, per instrumented operation, whether to inject a fault and which
kind.  Decisions come from two sources, checked in order:

* **scripted rules** (:class:`FaultRule`): match an operation name (fnmatch
  pattern) at an exact per-operation count (``nth``), on a period
  (``every``), or on every call;
* **random rates**: ``{op_pattern: {kind: probability}}`` drawn from one
  ``random.Random(seed)`` stream, so a faulted run of a deterministic
  workload is reproducible from the seed.

Every injection increments ``repro_faults_injected_total{op,kind}`` and the
plan's own ``injected`` tally.
"""
from __future__ import annotations

import errno
import random
from dataclasses import dataclass
from fnmatch import fnmatch

from ..obs import metrics as _metrics

__all__ = ["FAULT_KINDS", "FaultInjected", "FaultRule", "FaultPlan"]

#: every fault kind the injection surface understands.
#:   io_error    -- transient EIO: the op raises, nothing happened on disk
#:   enospc      -- out of space: a *prefix* of the data lands, then ENOSPC
#:   torn_write  -- short write: a prefix of the data lands, then EIO
#:   bit_flip    -- silent single-bit corruption of the written payload
#:   lying_fsync -- fsync returns success without making anything durable
#:   latency     -- the op succeeds after an injected delay
FAULT_KINDS = (
    "io_error", "enospc", "torn_write", "bit_flip", "lying_fsync", "latency",
)

_INJECTED = _metrics.counter(
    "repro_faults_injected_total",
    "Faults injected by the active FaultPlan, by operation and kind")


class FaultInjected(IOError):
    """A deliberately injected I/O failure (transient by construction).

    ``.op``/``.kind``/``.index`` identify the injection site.
    """

    def __init__(self, op: str, kind: str, index: int):
        ncode = errno.ENOSPC if kind == "enospc" else errno.EIO
        super().__init__(ncode, f"injected {kind} at {op}#{index}")
        self.op = op
        self.kind = kind
        self.index = index


@dataclass(frozen=True)
class FaultRule:
    """One scripted fault: ``kind`` fires when ``op`` matches the pattern.

    ``nth`` (1-based) fires on exactly the Nth matching operation;
    ``every`` fires on every ``every``-th; with neither, every matching
    operation faults.  ``arg`` is kind-specific: the surviving fraction for
    torn/ENOSPC writes, the delay in seconds for latency, ignored otherwise.
    """

    op: str
    kind: str
    nth: int | None = None
    every: int | None = None
    arg: float = 0.5

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    def fires_at(self, count: int) -> bool:
        if self.nth is not None:
            return count == self.nth
        if self.every is not None:
            return count % self.every == 0
        return True


class FaultPlan:
    """A deterministic schedule of faults over instrumented operations.

    ``rules`` are scripted (checked first, in order); ``rates`` add a
    seeded random layer: ``{op_pattern: {kind: probability}}``.  One
    operation suffers at most one fault per call.

    ``track_durability=True`` also arms the power-loss simulator in
    :mod:`repro_torch.faults.fs`: writes, fsyncs and renames are journaled
    so that :func:`repro_torch.faults.fs.simulate_power_loss` can make the
    un-fsynced state vanish (the lying-fsync test mode).
    """

    def __init__(self, rules=(), *, seed: int = 0, rates=None,
                 track_durability: bool = False):
        self.rules = tuple(rules)
        self.rates = {str(k): dict(v) for k, v in (rates or {}).items()}
        self.seed = int(seed)
        self.track_durability = bool(track_durability)
        self._rng = random.Random(self.seed)
        self.op_counts: dict[str, int] = {}  # ops seen, faulted or not
        self.injected: dict[tuple[str, str], int] = {}  # (op, kind) -> n
        self.log: list[tuple[str, str, int]] = []  # (op, kind, op_index)

    @classmethod
    def chaos(cls, seed: int, rates, **kw) -> "FaultPlan":
        """A purely random schedule."""
        return cls((), seed=seed, rates=rates, **kw)

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def decide(self, op: str):
        """Return ``(kind, arg, op_index)`` to inject, or ``None``.

        Counts every call per exact op name, then consults the scripted
        rules and the random rates.  The RNG is consumed once per matching
        rate entry in sorted order, so the schedule is a pure function of
        the seed and the operation stream.
        """
        count = self.op_counts.get(op, 0) + 1
        self.op_counts[op] = count
        for rule in self.rules:
            if fnmatch(op, rule.op) and rule.fires_at(count):
                return self._record(op, rule.kind, rule.arg, count)
        for pattern in sorted(self.rates):
            if not fnmatch(op, pattern):
                continue
            for kind in sorted(self.rates[pattern]):
                prob = self.rates[pattern][kind]
                if self._rng.random() < prob:
                    arg = 0.001 if kind == "latency" else 0.5
                    return self._record(op, kind, arg, count)
        return None

    def _record(self, op: str, kind: str, arg: float, count: int):
        key = (op, kind)
        self.injected[key] = self.injected.get(key, 0) + 1
        self.log.append((op, kind, count))
        _INJECTED.labels(op=op, kind=kind).inc()
        return kind, arg, count
