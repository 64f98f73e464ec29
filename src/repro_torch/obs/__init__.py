"""Telemetry of the port: metrics registry, Chrome-trace spans and the
benches' shared result block."""
from .metrics import (  # noqa: F401
    OBS_ENV_VAR,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
    obs_enabled,
    sum_by_name,
)
from .trace import (  # noqa: F401
    TRACE_ENV_VAR,
    Span,
    TraceCollector,
    clear_trace,
    get_collector,
    instant,
    save_trace,
    span,
    start_trace,
    stop_trace,
)
from .bench import OBS_BENCH_SCHEMA, shared_result  # noqa: F401

__all__ = [
    "OBS_ENV_VAR", "TRACE_ENV_VAR", "OBS_BENCH_SCHEMA",
    "DEFAULT_TIME_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Span", "TraceCollector", "counter", "gauge",
    "histogram", "get_registry", "get_collector", "obs_enabled",
    "sum_by_name", "shared_result", "span", "instant", "start_trace",
    "stop_trace", "save_trace", "clear_trace",
]
