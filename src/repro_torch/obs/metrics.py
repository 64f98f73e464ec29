"""Process-local metrics registry: counters and fixed-bucket histograms.

The port's own copy of ``repro/obs/metrics.py``, cut to what the
decomposition slice writes.  Metric names are the reference's, so a
registry delta around one ``decompose()`` reconciles with its
``DecompResult`` exactly as in the reference.  ``REPRO_TORCH_OBS=0``
turns every mutator into a no-op; it is read per call.
"""
from __future__ import annotations

import bisect
import os
from typing import Dict, Iterable, Mapping, Tuple

__all__ = [
    "OBS_ENV_VAR",
    "obs_enabled",
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "counter",
    "histogram",
    "sum_by_name",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_COUNT_BUCKETS",
]

OBS_ENV_VAR = "REPRO_TORCH_OBS"

#: log-ish spaced latency buckets, 100µs .. 10s (upper bounds, seconds).
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: size-like buckets (group sizes, node counts): upper bounds.
DEFAULT_COUNT_BUCKETS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def obs_enabled() -> bool:
    """True unless the process was told ``REPRO_TORCH_OBS=0``."""
    return os.environ.get(OBS_ENV_VAR, "1") != "0"


def _label_key(labels: Mapping[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if obs_enabled():
            self.value += amount


class _HistogramSeries:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self.buckets = buckets  # sorted upper bounds; +Inf bucket is implicit
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not obs_enabled():
            return
        value = float(value)
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1


class _MetricFamily:
    kind = "untyped"

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._series: Dict[_LabelKey, object] = {}

    def _make_series(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **labels: str):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._make_series()
            self._series[key] = s
        return s


class Counter(_MetricFamily):
    kind = "counter"

    def _make_series(self) -> _CounterSeries:
        return _CounterSeries()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        """The family's total over every label series."""
        return sum(s.value for s in self._series.values())


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> None:
        super().__init__(name, help)
        bks = tuple(sorted(float(b) for b in buckets))
        if not bks:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_bounds = bks

    def _make_series(self) -> _HistogramSeries:
        return _HistogramSeries(self.bucket_bounds)

    def observe(self, value: float) -> None:
        self.labels().observe(value)


class MetricsRegistry:
    """Metric families by name; families are create-once, get-forever.

        snap = reg.snapshot()
        ...work...
        d = reg.delta(snap)          # flat {sample_name: numeric delta}
    """

    def __init__(self) -> None:
        self._families: Dict[str, _MetricFamily] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            fam = cls(name, help, **kw)
            self._families[name] = fam
        elif not isinstance(fam, cls):
            raise TypeError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` of all monotonic samples
        (counters, and each histogram's ``_sum`` and ``_count``)."""
        out: Dict[str, float] = {}
        for fam in self._families.values():
            for key, series in fam._series.items():
                lbl = _format_labels(key)
                if fam.kind == "counter":
                    out[f"{fam.name}{lbl}"] = series.value
                else:
                    out[f"{fam.name}_sum{lbl}"] = series.sum
                    out[f"{fam.name}_count{lbl}"] = float(series.count)
        return out

    def delta(self, since: Mapping[str, float]) -> Dict[str, float]:
        """Current snapshot minus ``since`` (samples born later count fully)."""
        now = self.snapshot()
        return {k: v - since.get(k, 0.0) for k, v in now.items()}


def sum_by_name(delta: Mapping[str, float], name: str) -> float:
    """Sum a flat snapshot/delta across all label series of one family."""
    pref = name + "{"
    return sum(v for k, v in delta.items() if k == name or k.startswith(pref))


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every repro_torch module writes to."""
    return _default_registry


def counter(name: str, help: str = "") -> Counter:
    return _default_registry.counter(name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return _default_registry.histogram(name, help, buckets=buckets)
