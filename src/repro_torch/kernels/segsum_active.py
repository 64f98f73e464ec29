"""Block-skipping segment sum: the CUDA kernels and their plain PyTorch
versions.

The counterpart of ``repro/kernels/segsum_active.py``
(``segsum_active_partials``, with the block-activity mask and the window
epilogue of ``ops.make_superstep_segsum``).  A block of edges is
``[b·block_edges, (b+1)·block_edges) ∩ [0, E)``; it is active iff
``node_active[rows[e]]`` holds for some edge ``e`` in it.  Then
``out[r] = Σ vals[e]`` over the edges with ``rows[e] == r`` in active
blocks only: a row whose edges span an active and a skipped block gets the
sum over its active-block edges, neither 0 nor its full sum.  An inactive
block reads none of its values.

Two kernels of ``csrc/segsum.cu``:

* ``block_flags`` — the (nb,) int32 flags, once per pass;
* ``segment_sum_active`` — the segment sum of :mod:`.segsum` reading one
  flag per block (the same ``ss_segsum`` kernel, given the flag array).

:func:`make_superstep_segsum` computes a pass's flags once and returns an
``apply(vals)`` for the pass's probes; :func:`segment_sum_active` is the
one-shot form.  They are the counterparts of the reference's
``ops.make_superstep_segsum`` and ``ops.segment_sum_active``.

The block size that decides activity must be the one the caller accounts
blocks at (the engine's ``min(block_edges, 512)``).  The reference pads E
up to a block multiple by repeating the last row; the kernels work on the
exact E, whose last partial block is active iff one of its real rows is —
the same flags.  Rows must be sorted (not checked), as in :mod:`.segsum`.

The wrappers run the kernels for CUDA tensors and the plain versions for
CPU tensors; there is no other route.  ``*_plain`` runs on any device.
``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from . import segsum as _ss

__all__ = ["LAUNCHES", "reset_launch_counts", "block_flags",
           "block_flags_plain", "segsum_active", "segsum_active_plain",
           "make_superstep_segsum", "segment_sum_active"]

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"block_flags": 0, "segment_sum_active": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_flags_operands(rows, node_active, block_edges: int) -> None:
    if rows.dtype != torch.int32 or node_active.dtype != torch.bool:
        raise TypeError(f"rows must be torch.int32 and node_active "
                        f"torch.bool, got {rows.dtype} and "
                        f"{node_active.dtype}")
    if node_active.device != rows.device:
        raise ValueError(f"node_active is on {node_active.device}, rows on "
                         f"{rows.device}")
    if rows.dim() != 1 or node_active.dim() != 1:
        raise ValueError("rows and node_active must be 1-D")
    if not (rows.is_contiguous() and node_active.is_contiguous()):
        raise ValueError("rows and node_active must be contiguous")
    _ss.check_sizes(rows.shape[0], node_active.shape[0], block_edges)


def _check_flags(flags, rows, block_edges: int) -> None:
    nb = _ss.num_blocks(rows.shape[0], block_edges)
    if flags.dtype != torch.int32 or flags.device != rows.device \
            or tuple(flags.shape) != (nb,) or not flags.is_contiguous():
        raise ValueError(f"flags must be a contiguous ({nb},) int32 tensor on "
                         f"{rows.device}, got {flags.dtype} "
                         f"{tuple(flags.shape)} on {flags.device}")


# ------------------------------------------------------- plain versions
def block_flags_plain(rows, node_active, block_edges: int = 512):
    """(nb,) int32: 1 iff some edge of the block has an active row."""
    _check_flags_operands(rows, node_active, block_edges)
    E, n = rows.shape[0], node_active.shape[0]
    nb = _ss.num_blocks(E, block_edges)
    valid = (rows >= 0) & (rows < n)
    hit = valid & node_active[torch.where(valid, rows, 0)] if n else valid
    hit = torch.cat([hit, hit.new_zeros(nb * block_edges - E)])
    return hit.view(nb, block_edges).any(1).to(torch.int32)


def segsum_active_plain(vals, rows, flags, num_segments: int,
                        block_edges: int = 512):
    """The block-flag mask times ``vals``, then ``index_add_`` over
    ``rows``."""
    _ss.check_operands(vals, rows, num_segments, block_edges)
    _check_flags(flags, rows, block_edges)
    keep = flags.bool().repeat_interleave(block_edges)[:rows.shape[0]]
    return _ss.masked_sum_plain(vals, rows, keep, num_segments)


# ----------------------------------------------------------- dispatch
def block_flags(rows, node_active, block_edges: int = 512):
    """Per-block activity flags: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if rows.device.type == "cpu":
        return block_flags_plain(rows, node_active, block_edges)
    if rows.device.type != "cuda":
        raise ValueError(f"no block flags for device {rows.device}")
    _check_flags_operands(rows, node_active, block_edges)
    E = rows.shape[0]
    flags = torch.empty(_ss.num_blocks(E, block_edges), dtype=torch.int32,
                        device=rows.device)
    if E:
        lib = _ss._lib()
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ss_block_flags(rows.data_ptr(), node_active.data_ptr(),
                                     E, block_edges, node_active.shape[0],
                                     flags.data_ptr(), stream)
        LAUNCHES["block_flags"] += 1
        if err:
            raise RuntimeError(f"block_flags launch failed: CUDA error {err}")
    return flags


def segsum_active(vals, rows, flags, num_segments: int,
                  block_edges: int = 512):
    """Block-skipping segment sum given the pass's ``flags``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if vals.device.type == "cpu":
        return segsum_active_plain(vals, rows, flags, num_segments,
                                   block_edges)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment sum for device {vals.device}")
    _ss.check_operands(vals, rows, num_segments, block_edges)
    _check_flags(flags, rows, block_edges)
    return _ss.launch_segsum(vals, rows, flags, num_segments, block_edges,
                             "segment_sum_active", LAUNCHES)


# -------------------------------------------------------- entry points
def make_superstep_segsum(rows, node_active, num_segments: int, *,
                          block_edges: int = 512):
    """Superstep-granular entry to the block-skipping segment sum.

    One pass runs several sums over the same ``rows`` with the same
    frontier mask (the h-index probes and the cnt refresh): the per-block
    activity flags are computed here once, and the returned ``apply(vals)``
    runs one skipping sum per call.
    """
    flags = block_flags(rows, node_active, block_edges)

    def apply(vals):
        return segsum_active(vals, rows, flags, num_segments, block_edges)

    return apply


def segment_sum_active(vals, rows, node_active, num_segments: int, *,
                       block_edges: int = 512):
    """Block-skipping segment sum: blocks with no active row contribute
    nothing and are not read.  One-shot form of
    :func:`make_superstep_segsum`."""
    return make_superstep_segsum(rows, node_active, num_segments,
                                 block_edges=block_edges)(vals)
