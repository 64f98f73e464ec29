"""Telemetry of the port: metrics registry + Chrome-trace spans."""
from .metrics import (  # noqa: F401
    OBS_ENV_VAR,
    Counter,
    Histogram,
    MetricsRegistry,
    counter,
    get_registry,
    histogram,
    obs_enabled,
    sum_by_name,
)
from .trace import (  # noqa: F401
    TRACE_ENV_VAR,
    clear_trace,
    get_collector,
    instant,
    save_trace,
    span,
    start_trace,
    stop_trace,
)

__all__ = [
    "OBS_ENV_VAR", "TRACE_ENV_VAR", "Counter", "Histogram",
    "MetricsRegistry", "counter", "histogram", "get_registry",
    "get_collector", "obs_enabled", "sum_by_name", "span", "instant",
    "start_trace", "stop_trace", "save_trace", "clear_trace",
]
