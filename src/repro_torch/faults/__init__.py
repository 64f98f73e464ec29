"""Deterministic fault injection and resilience policies.

The port's own copy of ``repro/faults``.  The paper's claim is a
disk-backed one, and disk-backed systems fail in ways clean tests never
exercise: torn writes, bit rot, transient ``EIO``, ``ENOSPC``, drives that
acknowledge an fsync they never performed.  This package makes those
failures a reproducible test input:

* :mod:`plan` — ``FaultPlan``/``FaultRule``: a seeded, scriptable schedule
  of faults keyed by operation count (the Kth block read), so a test can
  place a fault at an exact point or run a randomized schedule that is
  reproducible from one integer seed;
* :mod:`fs` — the injection surface: filesystem side effects (and
  ``BlockReader`` block fills) call a hook here.  With no plan installed
  each hook is a single ``is None`` check.  Also hosts the power-loss
  simulator behind the lying-fsync mode;
* :mod:`retry` — ``RetryPolicy`` (jittered exponential backoff with a
  retry budget and deadline) and ``CircuitBreaker``.

Injected faults surface as :class:`FaultInjected` (an ``IOError``
subclass, so retry and except paths treat them as real I/O errors) and
are counted in ``repro_faults_injected_total{op,kind}``.
"""
from .plan import FAULT_KINDS, FaultInjected, FaultPlan, FaultRule
from .fs import active_plan, flip_bit, inject, simulate_power_loss
from .retry import CircuitBreaker, RetryPolicy

__all__ = [
    "FAULT_KINDS", "FaultInjected", "FaultPlan", "FaultRule",
    "active_plan", "flip_bit", "inject", "simulate_power_loss",
    "CircuitBreaker", "RetryPolicy",
]
