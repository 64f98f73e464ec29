"""Streaming core-graph service: online coreness queries over an edge stream.

The port's own copy of ``repro/stream``.  Built on the paper's §V
maintenance algorithms and split CQRS-style: ``CoreWriter`` (the
established ``CoreService``) owns the semi-external node state, ingests
insert/delete micro-batches through ``CoreMaintainer``/``BufferedGraph``
and appends them to the WAL before applying; ``CoreReplica`` read replicas
bootstrap from the latest snapshot, tail the WAL incrementally
(``WalTailer``) and serve the same epoch-versioned query surface from their
own views with per-reply staleness watermarks.  WAL + snapshots give crash
recovery via warm restart; the WAL rotates on snapshot publish so the log
size tracks the snapshot interval.  Every settle runs on the port's
backends: "cuda" on cuda:0 unless ``backend``/``device`` say otherwise.
"""
from ..core.update import Delete, Insert, UpdateBatch
from .admission import AdmittedBatch, admit_batch
from .backpressure import AdmissionController, Overloaded
from .integrity import CorruptionError, crc32c
from .replica import BootstrapStats, CoreReplica
from .service import (BatchStats, CoreService, CoreWriter, EpochView,
                      QueryAPI, RecoveryStats, Watermarked, WatermarkedArray)
from .wal import SnapshotStore, WalGap, WalTailer, WriteAheadLog
from .workload import mixed_stream

__all__ = [
    "Insert", "Delete", "UpdateBatch",
    "AdmittedBatch", "admit_batch",
    "AdmissionController", "Overloaded",
    "CorruptionError", "crc32c",
    "BatchStats", "CoreService", "CoreWriter", "CoreReplica", "EpochView",
    "QueryAPI", "RecoveryStats", "BootstrapStats",
    "Watermarked", "WatermarkedArray",
    "SnapshotStore", "WriteAheadLog", "WalTailer", "WalGap",
    "mixed_stream",
]
