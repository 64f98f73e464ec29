"""Retry and circuit-breaker policies for the disk-backed paths.

The port's own copy of ``repro/faults/retry.py``.  :class:`RetryPolicy`
wraps a callable with jittered exponential backoff under three limits:
attempt budget, total-delay deadline, and which exception types count as
transient.  :class:`CircuitBreaker` counts consecutive failures and trips
after a threshold.  Both are deterministic: the jitter RNG is seeded and
the sleep function is injectable.
"""
from __future__ import annotations

import random
import time

from ..obs import metrics as _metrics

__all__ = ["RetryPolicy", "CircuitBreaker"]

_RETRIES = _metrics.counter(
    "repro_retries_total",
    "I/O retries performed by RetryPolicy, by operation")
_EXHAUSTED = _metrics.counter(
    "repro_retries_exhausted_total",
    "RetryPolicy give-ups (budget or deadline exhausted), by operation")


class RetryPolicy:
    """Jittered exponential backoff with an attempt budget and a deadline.

    ``retries`` is the number of *re*-attempts after the first call (so
    ``retries=3`` means up to 4 calls).  Delay before retry ``k`` (1-based)
    is ``base_delay * 2**(k-1)`` capped at ``max_delay``, scaled by a
    uniform jitter in ``[1-jitter, 1]``.  ``deadline`` caps the *summed*
    sleep time; once it would be exceeded the policy gives up early.
    """

    def __init__(self, retries: int = 3, *, base_delay: float = 0.01,
                 max_delay: float = 1.0, deadline: float | None = None,
                 jitter: float = 0.5, seed: int = 0, sleep=time.sleep):
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.retries = int(retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = deadline
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delays(self):
        """Yield the backoff delays this policy would sleep, in order."""
        total = 0.0
        for k in range(self.retries):
            d = min(self.base_delay * (2.0 ** k), self.max_delay)
            d *= 1.0 - self.jitter * self._rng.random()
            if self.deadline is not None and total + d > self.deadline:
                return
            total += d
            yield d

    def call(self, fn, *args, op: str = "io", retry_on=(OSError,), **kw):
        """Invoke ``fn(*args, **kw)``, retrying on ``retry_on`` exceptions.

        Re-raises the last exception once the budget or deadline is spent;
        each retry bumps ``repro_retries_total{op}`` and each give-up bumps
        ``repro_retries_exhausted_total{op}``.
        """
        delays = self.delays()
        while True:
            try:
                return fn(*args, **kw)
            except retry_on:
                delay = next(delays, None)
                if delay is None:
                    _EXHAUSTED.labels(op=op).inc()
                    raise
                _RETRIES.labels(op=op).inc()
                self._sleep(delay)


class CircuitBreaker:
    """Trip after ``trip_after`` consecutive failures; reset on success.

    The breaker only reports its state; the caller decides what a trip
    means.
    """

    def __init__(self, trip_after: int = 3):
        if trip_after < 1:
            raise ValueError("trip_after must be >= 1")
        self.trip_after = int(trip_after)
        self.consecutive_failures = 0
        self.trips = 0

    @property
    def tripped(self) -> bool:
        return self.consecutive_failures >= self.trip_after

    def record_failure(self) -> bool:
        """Count a failure; returns True when this one trips the breaker."""
        self.consecutive_failures += 1
        if self.consecutive_failures == self.trip_after:
            self.trips += 1
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0

    def reset(self) -> None:
        self.consecutive_failures = 0
