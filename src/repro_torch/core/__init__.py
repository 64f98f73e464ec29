"""Semi-external core decomposition on PyTorch: SemiCore / SemiCore+ /
SemiCore* with the paper's I/O accounting, device-resident on the GPU."""
from .imcore import imcore_bz, imcore_peel
from .localcore import local_core, h_index_batch, compute_cnt_batch
from .engine import (
    ComputeBackend,
    CudaBackend,
    DecompResult,
    DeviceBackend,
    NumpyBackend,
    PassPlanner,
    resolve_backend,
    resolve_device,
    run_batch,
    warm_settle,
)
from .resident import run_resident
from .semicore import HostEngine, decompose

__all__ = [
    "imcore_bz", "imcore_peel", "local_core", "h_index_batch",
    "compute_cnt_batch", "ComputeBackend", "CudaBackend", "DecompResult",
    "DeviceBackend", "NumpyBackend", "PassPlanner", "resolve_backend",
    "resolve_device", "run_batch", "warm_settle", "run_resident",
    "HostEngine", "decompose",
]
