"""Segment sum over sorted rows: the CUDA kernel and its plain PyTorch
version.

The counterpart of ``repro/kernels/segsum.py`` (``segsum_pallas_partials``
with the window epilogue of ``ops.segment_sum``): ``out[r] = Σ vals[e]``
over the edges ``e`` with ``rows[e] == r``, for ``vals`` (E,) or (E, D) in
float32, bfloat16 or int32, ``rows`` (E,) int32 sorted non-decreasing in
``[0, num_segments)``.  The result has the dtype of ``vals``.

One launch of ``csrc/segsum.cu`` (``ss_segsum``) serves this module and
:mod:`.segsum_active`.  At D = 1 a card-sized grid of warps walks the edge
blocks, one warp a block, here every block, there the active blocks' list
(or, given flags alone, every block whose flag is set); wider values run a
thread block per edge block.  Integer values sum exactly in int32; float32
and bfloat16 sum in float32 and a bfloat16 result is rounded once at the
end.  Unsorted ``rows`` violate the precondition and are not checked (that
would cost a device pass); an edge whose row lies outside
``[0, num_segments)`` is dropped, as the reference's scatter drops it.
:func:`vector_width` picks 16-byte or scalar loads from the operands'
alignment and the block size.

The wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors; there is no other route.  ``segment_sum_plain`` runs the plain
version on any device.  ``LAUNCHES`` counts kernel launches;
:func:`blocks_read` reads the device counter of the edge blocks the kernel
actually read (both modules' launches).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE", "DTYPES",
           "VEC", "vector_width", "segment_sum", "segment_sum_plain",
           "blocks_read", "reset_blocks_read"]

KERNEL_SOURCE = "segsum"  # csrc/segsum.cu

#: value dtypes the kernel takes, with the source's `enum DType` codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

#: edges a 16-byte load of rows holds (``kVec`` of the source)
VEC = 4

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"segment_sum": 0}

_INT32_LIMIT = 1 << 31
_BLOCKS_READ: dict[torch.device, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def blocks_read(device) -> int:
    """Edge blocks the segment-sum kernel has read on ``device`` since the
    last :func:`reset_blocks_read` (one device-to-host read)."""
    t = _BLOCKS_READ.get(torch.device(device))
    return 0 if t is None else int(t.item())


def reset_blocks_read() -> None:
    for t in _BLOCKS_READ.values():
        t.zero_()


def _blocks_counter(device) -> torch.Tensor:
    t = _BLOCKS_READ.get(device)
    if t is None:
        t = torch.zeros(1, dtype=torch.int64, device=device)
        _BLOCKS_READ[device] = t
    return t


# ---------------------------------------------------------------- checks
def check_operands(vals, rows, num_segments: int, block_edges: int) -> None:
    """Dtype, device, shape, contiguity and int32 range of a segment sum's
    operands."""
    if vals.dtype not in DTYPES:
        raise TypeError(f"vals must be one of {sorted(map(str, DTYPES))}, "
                        f"got {vals.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be torch.int32, got {rows.dtype}")
    if rows.device != vals.device:
        raise ValueError(f"rows is on {rows.device}, vals on {vals.device}")
    if vals.dim() not in (1, 2) or rows.dim() != 1 \
            or vals.shape[0] != rows.shape[0]:
        raise ValueError(f"vals must be (E,) or (E, D) and rows (E,), got "
                         f"{tuple(vals.shape)} and {tuple(rows.shape)}")
    if not (vals.is_contiguous() and rows.is_contiguous()):
        raise ValueError("vals and rows must be contiguous")
    check_sizes(rows.shape[0], num_segments, block_edges)


def check_sizes(E: int, num_segments: int, block_edges: int) -> None:
    """Edge count, segment count and block size within the kernels' int32
    range."""
    if not 0 <= num_segments < _INT32_LIMIT or E >= _INT32_LIMIT:
        raise ValueError(f"num_segments={num_segments} or E={E} is outside "
                         "the int32 range")
    if not 0 < block_edges < _INT32_LIMIT:
        raise ValueError(f"block_edges must be positive, got {block_edges}")


def num_blocks(E: int, block_edges: int) -> int:
    return -(-E // block_edges)


def vector_width(block_edges: int, *tensors) -> int:
    """``VEC`` (16-byte loads: ``VEC`` int32 rows, float32 or int32 values a
    word, ``VEC`` bfloat16 values in 8 bytes) when every block of every
    tensor starts on a boundary of ``VEC`` elements, i.e. each tensor's
    start does and ``block_edges`` is a multiple of ``VEC``; else 1
    (scalar loads)."""
    if block_edges % VEC:
        return 1
    ok = all(t.data_ptr() % (VEC * t.element_size()) == 0 for t in tensors)
    return VEC if ok else 1


# ----------------------------------------------------------- CUDA route
def _lib():
    from . import _build

    lib = _build.load(KERNEL_SOURCE)
    if not getattr(lib, "_repro_sigs", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ss_block_flags.argtypes = [vp, vp, ll, i, i, i, vp, vp, vp, vp]
        lib.ss_block_flags.restype = i
        lib.ss_segsum.argtypes = [vp, vp, vp, vp, vp, ll, i, i, i, i, i, vp,
                                  vp, vp]
        lib.ss_segsum.restype = i
        lib._repro_sigs = True
    return lib


def launch_segsum(vals, rows, flags, num_segments: int, block_edges: int,
                  counter: str, launches: dict, blocks=None):
    """One ``ss_segsum`` launch on CUDA tensors (``flags`` None: every
    block; ``blocks`` the ``(ids, count)`` list of the flagged blocks, which
    D = 1 walks instead of the flags); counts it in
    ``launches[counter]``."""
    E = rows.shape[0]
    D = 1 if vals.dim() == 1 else vals.shape[1]
    acc_dtype = torch.int32 if vals.dtype == torch.int32 else torch.float32
    out = torch.zeros((num_segments, *vals.shape[1:]), dtype=acc_dtype,
                      device=vals.device)
    if E and D:
        lib = _lib()
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream().cuda_stream
            ids, count = (None, None) if blocks is None else \
                (blocks[0].data_ptr(), blocks[1].data_ptr())
            err = lib.ss_segsum(
                vals.data_ptr(), rows.data_ptr(),
                None if flags is None else flags.data_ptr(), ids, count, E,
                D, block_edges, num_segments, DTYPES[vals.dtype],
                vector_width(block_edges, rows, vals), out.data_ptr(),
                _blocks_counter(vals.device).data_ptr(), stream)
        launches[counter] += 1
        if err:
            raise RuntimeError(f"{counter} launch failed: CUDA error {err}")
    return out if out.dtype == vals.dtype else out.to(vals.dtype)


# ------------------------------------------------------- plain version
def masked_sum_plain(vals, rows, edge_keep, num_segments: int):
    """``index_add_`` of the kept edges' values over ``rows`` in the
    kernel's accumulator type (int32, else float32), rounded to the input
    dtype once; edges with a row outside ``[0, num_segments)`` are
    dropped."""
    acc_dtype = torch.int32 if vals.dtype == torch.int32 else torch.float32
    keep = (rows >= 0) & (rows < num_segments)
    if edge_keep is not None:
        keep &= edge_keep
    out = torch.zeros((num_segments, *vals.shape[1:]), dtype=acc_dtype,
                      device=vals.device)
    out.index_add_(0, rows[keep], vals[keep].to(acc_dtype))
    return out.to(vals.dtype)


def segment_sum_plain(vals, rows, num_segments: int, block_edges: int = 512):
    """The segment sum in plain torch ops, on any device."""
    check_operands(vals, rows, num_segments, block_edges)
    return masked_sum_plain(vals, rows, None, num_segments)


# ----------------------------------------------------------- dispatch
def segment_sum(vals, rows, num_segments: int, block_edges: int = 512):
    """Segment sum: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``block_edges`` is the kernel's edge block (one warp each
    at D = 1); it does not change the result."""
    check_operands(vals, rows, num_segments, block_edges)
    if vals.device.type == "cuda":
        return launch_segsum(vals, rows, None, num_segments, block_edges,
                             "segment_sum", LAUNCHES)
    if vals.device.type == "cpu":
        return masked_sum_plain(vals, rows, None, num_segments)
    raise ValueError(f"no segment sum for device {vals.device}")
