"""Chrome-trace-format span timeline for supersteps.

The port's own copy of ``repro/obs/trace.py``: complete events (``ph: "X"``)
for timed spans and instant events (``ph: "i"``) for replayed per-pass
markers, timestamps in microseconds since ``start_trace()``.  Spans only
read values the host already has, so tracing adds no device round-trip.
Off unless a collector was started (``start_trace()`` or
``REPRO_TORCH_TRACE``) and ``REPRO_TORCH_OBS`` is not ``0``.

``REPRO_TORCH_TRACE`` values: unset/``0`` — off; ``1`` — collect (caller
saves); any other string — collect and save to that path at exit.
"""
from __future__ import annotations

import atexit
import json
import os
import time
from typing import List

from .metrics import obs_enabled

__all__ = [
    "TRACE_ENV_VAR",
    "Span",
    "TraceCollector",
    "get_collector",
    "start_trace",
    "stop_trace",
    "save_trace",
    "clear_trace",
    "span",
    "instant",
]

TRACE_ENV_VAR = "REPRO_TORCH_TRACE"


class _NullSpan:
    """Shared do-nothing span handed out when tracing is off."""

    __slots__ = ()
    active = False

    def set(self, **args) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Span:
    """A timed complete event; use as a context manager."""

    __slots__ = ("_collector", "name", "cat", "args", "_t0")
    active = True

    def __init__(self, collector: "TraceCollector", name: str, cat: str,
                 args: dict):
        self._collector = collector
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._collector._emit_complete(self)


class TraceCollector:
    """Accumulates trace events; one per process."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self.active = False
        self._epoch = 0.0
        self._pid = os.getpid()

    def start(self) -> None:
        if not self.active:
            self.active = True
            self._epoch = time.perf_counter()

    def stop(self) -> None:
        self.active = False

    def clear(self) -> None:
        self.events = []
        self._epoch = time.perf_counter()

    def _enabled(self) -> bool:
        return self.active and obs_enabled()

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def span(self, name: str, cat: str = "repro", **args):
        if not self._enabled():
            return _NULL_SPAN
        return Span(self, name, cat, args)

    def _emit_complete(self, sp: Span) -> None:
        if not self._enabled():
            return
        now = time.perf_counter()
        self.events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": self._us(sp._t0), "dur": (now - sp._t0) * 1e6,
            "pid": self._pid, "tid": 0, "args": sp.args,
        })

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        if not self._enabled():
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i",
            "ts": self._us(time.perf_counter()), "s": "t",
            "pid": self._pid, "tid": 0, "args": args,
        })

    def to_chrome(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(), f)
        return path


_collector = TraceCollector()


def get_collector() -> TraceCollector:
    return _collector


def start_trace() -> None:
    """Begin collecting trace events (idempotent)."""
    _collector.start()


def stop_trace() -> None:
    _collector.stop()


def clear_trace() -> None:
    _collector.clear()


def save_trace(path: str) -> str:
    """Write the collected timeline as Chrome-trace JSON; returns the path."""
    return _collector.save(path)


def span(name: str, cat: str = "repro", **args):
    """Open a span against the process collector (no-op when off)."""
    return _collector.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    _collector.instant(name, cat, **args)


def _init_from_env() -> None:
    val = os.environ.get(TRACE_ENV_VAR, "")
    if not val or val == "0":
        return
    start_trace()
    if val != "1":
        atexit.register(save_trace, val)


_init_from_env()
