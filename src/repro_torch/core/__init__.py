"""Semi-external core decomposition on PyTorch: SemiCore / SemiCore+ /
SemiCore* with the paper's I/O accounting, device-resident on the GPU,
and edge-update maintenance (SemiDelete*, SemiInsert, SemiInsert*, the
grouped masked settle) over it; EMCore, the external-memory baseline."""
from .imcore import imcore_bz, imcore_peel
from .emcore import EMCoreResult, emcore
from .localcore import local_core, h_index_batch, compute_cnt_batch
from .engine import (
    ComputeBackend,
    CudaBackend,
    DecompResult,
    DeviceBackend,
    NumpyBackend,
    PassPlanner,
    TorchBackend,
    edge_ge_counts,
    hindex_bsearch,
    resolve_backend,
    resolve_device,
    run_batch,
    warm_settle,
)
from .resident import run_resident
from .semicore import HostEngine, decompose
from .update import Delete, Insert, UpdateBatch
from .maintenance import BatchMaintStats, CoreMaintainer, MaintStats

__all__ = [
    "imcore_bz", "imcore_peel", "emcore", "EMCoreResult", "local_core", "h_index_batch",
    "compute_cnt_batch", "ComputeBackend", "CudaBackend", "DecompResult",
    "DeviceBackend", "NumpyBackend", "PassPlanner", "TorchBackend",
    "edge_ge_counts", "hindex_bsearch", "resolve_backend",
    "resolve_device", "run_batch", "warm_settle", "run_resident",
    "HostEngine", "decompose", "Insert", "Delete", "UpdateBatch",
    "CoreMaintainer", "MaintStats", "BatchMaintStats",
]
