"""Shared result schema for benchmark scripts.

The port's own copy of ``repro/obs/bench.py``.  A bench embeds one common
block, sourced from the metrics registry via snapshot/delta, so tooling
reads any bench output the same way::

    {
      "schema": "repro-obs-bench-v1",
      "bench": "<script name>",
      "wall_seconds": ...,
      "counters": {"repro_io_edge_block_reads_total": ..., ...},
      "derived": {"io_bytes_per_s": ..., ...}
    }

``counters`` is the flat registry delta for the measured region (label
suffixes preserved); ``derived`` holds a few convenience rates.
"""
from __future__ import annotations

from typing import Mapping, Optional

from .metrics import sum_by_name

__all__ = ["OBS_BENCH_SCHEMA", "shared_result"]

OBS_BENCH_SCHEMA = "repro-obs-bench-v1"


def shared_result(bench: str, wall_seconds: Optional[float],
                  counters: Mapping[str, float],
                  extra: Optional[dict] = None) -> dict:
    """Build the common bench block from a registry delta."""
    kept = {k: v for k, v in counters.items()
            if k.startswith("repro_") and v != 0}
    out: dict = {
        "schema": OBS_BENCH_SCHEMA,
        "bench": bench,
        "wall_seconds": wall_seconds,
        "counters": kept,
        "derived": {},
    }
    if wall_seconds and wall_seconds > 0:
        io_bytes = sum_by_name(kept, "repro_io_bytes_read_total")
        if io_bytes:
            out["derived"]["io_bytes_per_s"] = io_bytes / wall_seconds
        passes = sum_by_name(kept, "repro_engine_passes_total")
        if passes:
            out["derived"]["passes_per_s"] = passes / wall_seconds
    if extra:
        out["derived"].update(extra)
    return out
