"""One decomposition superstep per call: the CUDA kernel pair and its plain
PyTorch version.

The counterpart of ``repro/kernels/fused_superstep.py`` (``fused_pass``,
``fused_hindex``, ``fused_counts``): the same outputs with the same
meaning, in int32, over the flat CSR table of the device-resident
structure (``segptr`` (n+1,), ``nbr`` (E,)).  The CSR must be undirected
(every edge in both endpoint lists), as every ``CSRGraph`` is: the push
pass relies on that symmetry.

A superstep is two launches of ``csrc/fused_superstep.cu``:

* ``row_pass`` (phase 0): per active row, the capped h-index of the
  pass-start neighbour cores and the refreshed cnt at h, or a count at a
  given threshold; ``upd = #(active & h != core)``;
* ``push_pass`` (phase 1, semicore* and semicore+): each active row whose
  core changed pushes cnt decrements (semicore*) or touched marks
  (semicore+) to its neighbours.

The wrappers run the kernels for CUDA tensors and the plain version for
CPU tensors; there is no other route.  ``*_plain`` runs the plain version
on any device (the card's parity checks use it).  ``LAUNCHES`` counts the
kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE",
    "fused_pass", "fused_hindex", "fused_counts",
    "fused_pass_plain", "fused_hindex_plain", "fused_counts_plain",
    "row_pass", "push_pass", "row_pass_plain", "push_pass_plain",
    "MODE_HINDEX", "MODE_COUNTS", "MODE_SEMICORE", "MODE_SEMICORE_PLUS",
    "MODE_SEMICORE_STAR",
]

KERNEL_SOURCE = "fused_superstep"  # csrc/fused_superstep.cu

# modes of the row pass; the values are the CUDA source's `enum Mode`
MODE_HINDEX = 0          # (h, cnt at h)
MODE_COUNTS = 1          # count at a given threshold
MODE_SEMICORE = 2        # core2
MODE_SEMICORE_PLUS = 3   # core2 (+ push: touched marks)
MODE_SEMICORE_STAR = 4   # core2, refreshed cnt (+ push: cnt decrements)
_ALGORITHM_MODE = {"semicore": MODE_SEMICORE, "semicore+": MODE_SEMICORE_PLUS,
                   "semicore*": MODE_SEMICORE_STAR}

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"row_pass": 0, "push_pass": 0}

_INT32_LIMIT = 1 << 31


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- checks
def _check(segptr, nbr, core, aux, active, *extra) -> int:
    """Device, dtype, shape, contiguity and int32 range of the operands;
    returns n.  Neighbour ids themselves are range-checked once, when the
    resident structure is built (resident.build_structure)."""
    n = core.shape[0] if core.dim() == 1 else -1
    dev = core.device
    named = [("segptr", segptr, torch.int32, n + 1), ("nbr", nbr, torch.int32, None),
             ("core", core, torch.int32, n), ("active", active, torch.bool, n)]
    if aux is not None:
        named.append(("aux", aux, torch.int32, n))
    named += [(f"out{i}", t, torch.int32, n) for i, t in enumerate(extra)]
    for name, t, dtype, length in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, core on {dev}")
        if t.dim() != 1 or (length is not None and t.shape[0] != length):
            raise ValueError(f"{name} must be 1-D of length {length}, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n + 1 >= _INT32_LIMIT or nbr.shape[0] >= _INT32_LIMIT:
        raise ValueError(f"n={n} or E={nbr.shape[0]} exceeds int32 range")
    return n


# ----------------------------------------------------------- CUDA route
def _lib():
    from . import _build

    lib = _build.load(KERNEL_SOURCE)
    if not getattr(lib, "_repro_sigs", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fs_row_pass.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp, vp, vp]
        lib.fs_row_pass.restype = i
        lib.fs_push_pass.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp]
        lib.fs_push_pass.restype = i
        lib._repro_sigs = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _row_pass_cuda(mode, segptr, nbr, core, aux, active):
    n = _check(segptr, nbr, core, aux, active)
    out_a = torch.empty_like(core)
    out_b = torch.empty_like(core) \
        if mode in (MODE_HINDEX, MODE_SEMICORE_STAR) else None
    upd = torch.zeros(1, dtype=torch.int32, device=core.device)
    if n:
        lib = _lib()
        with torch.cuda.device(core.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fs_row_pass(
                _ptr(segptr), _ptr(nbr), _ptr(core), _ptr(aux), _ptr(active),
                n, mode, _ptr(out_a), _ptr(out_b), _ptr(upd), stream)
        LAUNCHES["row_pass"] += 1
        if err:
            raise RuntimeError(f"row_pass launch failed: CUDA error {err}")
    return out_a, out_b, upd[0]


def _push_pass_cuda(mode, segptr, nbr, core, core2, active, target):
    n = _check(segptr, nbr, core, None, active, core2, target)
    if n:
        lib = _lib()
        with torch.cuda.device(core.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fs_push_pass(
                _ptr(segptr), _ptr(nbr), _ptr(core), _ptr(core2),
                _ptr(active), n, mode, _ptr(target), stream)
        LAUNCHES["push_pass"] += 1
        if err:
            raise RuntimeError(f"push_pass launch failed: CUDA error {err}")


# ------------------------------------------------------- plain version
def _rows(segptr, nbr):
    """(row of each edge, degree of each row), int32."""
    deg = segptr[1:] - segptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(deg.shape[0], dtype=torch.int32, device=deg.device), deg,
        output_size=nbr.shape[0])
    return rows, deg


def _segsum(x, segptr):
    """Per-row sums of an edge-aligned array over the sorted CSR rows:
    prefix sum + boundary gathers, bounded by segptr."""
    cs = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(x, 0, dtype=torch.int32, out=cs[1:])
    return cs[segptr[1:]] - cs[segptr[:-1]]


def row_pass_plain(mode, segptr, nbr, core, aux, active):
    """The row pass in plain torch ops, element for element the kernel's
    result: ``(out_a, out_b or None, upd)``."""
    _check(segptr, nbr, core, aux, active)
    rows, deg = _rows(segptr, nbr)
    act = active & (deg > 0)
    vals = core[nbr]
    if mode == MODE_COUNTS:
        c = _segsum(vals >= aux[rows], segptr)
        return torch.where(act, c, 0), None, \
            torch.zeros((), dtype=torch.int32, device=core.device)
    # vectorized binary search for h = max k <= min(cap, deg) with
    # #(vals >= k) >= k; c_lo tracks the count at the current lower end
    # (0 off the frontier)
    lo = torch.zeros_like(core)
    hi = torch.where(act, torch.minimum(core, deg).clamp_(min=0), lo)
    c_lo = torch.where(act, deg, lo)
    probes = int(hi.max()).bit_length() if hi.numel() else 0
    for _ in range(probes):
        search = lo < hi
        mid = lo + (hi - lo + 1) // 2
        c = _segsum(vals >= mid[rows], segptr)
        ok = search & (c >= mid)
        lo = torch.where(ok, mid, lo)
        c_lo = torch.where(ok, c, c_lo)
        hi = torch.where(search & ~ok, mid - 1, hi)
    upd = (act & (lo != core)).sum(dtype=torch.int32)
    if mode == MODE_HINDEX:
        return lo, c_lo, upd
    core2 = torch.where(active, lo, core)
    if mode == MODE_SEMICORE_STAR:
        return core2, torch.where(active, c_lo, aux), upd
    return core2, None, upd


def push_pass_plain(mode, segptr, nbr, core, core2, active, target):
    """The push pass in plain torch ops; updates ``target`` in place."""
    _check(segptr, nbr, core, None, active, core2, target)
    rows, _ = _rows(segptr, nbr)
    pushing = (active & (core2 != core))[rows]
    u = nbr[pushing]
    if mode == MODE_SEMICORE_STAR:
        v = rows[pushing]
        c2 = core2[u]
        dst = u[(c2 > core2[v]) & (c2 <= core[v])]
        target.index_add_(0, dst, torch.full_like(dst, -1))
    else:
        target[u] = 1


# ----------------------------------------------------------- dispatch
def row_pass(mode, segptr, nbr, core, aux, active):
    """Row pass: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if core.device.type == "cuda":
        return _row_pass_cuda(mode, segptr, nbr, core, aux, active)
    if core.device.type == "cpu":
        return row_pass_plain(mode, segptr, nbr, core, aux, active)
    raise ValueError(f"no fused superstep for device {core.device}")


def push_pass(mode, segptr, nbr, core, core2, active, target):
    """Push pass: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if core.device.type == "cuda":
        return _push_pass_cuda(mode, segptr, nbr, core, core2, active, target)
    if core.device.type == "cpu":
        return push_pass_plain(mode, segptr, nbr, core, core2, active, target)
    raise ValueError(f"no fused superstep for device {core.device}")


def _superstep(rp, pp, core, cnt, active, segptr, nbr, algorithm):
    mode = _ALGORITHM_MODE.get(algorithm)
    if mode is None:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    core2, cnt2, upd = rp(mode, segptr, nbr, core,
                          cnt if mode == MODE_SEMICORE_STAR else None, active)
    if mode == MODE_SEMICORE:
        return core2, cnt, active, upd
    if mode == MODE_SEMICORE_PLUS:
        touched = torch.zeros_like(core)
        pp(mode, segptr, nbr, core, core2, active, touched)
        return core2, cnt, (touched > 0) & (core2 > 0), upd
    pp(mode, segptr, nbr, core, core2, active, cnt2)
    return core2, cnt2, (cnt2 < core2) & (core2 > 0), upd


def fused_pass(core, cnt, active, segptr, nbr, *, algorithm: str):
    """One engine superstep.

    ``core``/``cnt`` int32 (n,), ``active`` bool (n,).  Returns
    ``(core2, cnt2, active2, upd)`` with the semantics of the reference
    ``fused_pass``: ``cnt``/``active`` pass through for algorithms that do
    not track them, ``upd`` is a 0-dim int32 tensor on the device.
    """
    return _superstep(row_pass, push_pass, core, cnt, active, segptr, nbr,
                      algorithm)


def fused_pass_plain(core, cnt, active, segptr, nbr, *, algorithm: str):
    """:func:`fused_pass` through the plain version on any device."""
    return _superstep(row_pass_plain, push_pass_plain, core, cnt, active,
                      segptr, nbr, algorithm)


def fused_hindex(core, active, segptr, nbr):
    """Per-pass path: ``(h, cnt_at_h)`` for the frontier in one launch —
    ``h`` the cap-bounded h-index of the pass-start neighbour cores,
    ``cnt_at_h`` the refreshed #(nbr core >= h); both 0 off the frontier."""
    h, c, _ = row_pass(MODE_HINDEX, segptr, nbr, core, None, active)
    return h, c


def fused_hindex_plain(core, active, segptr, nbr):
    h, c, _ = row_pass_plain(MODE_HINDEX, segptr, nbr, core, None, active)
    return h, c


def fused_counts(core, thresholds, active, segptr, nbr):
    """#(nbr pass-start core >= threshold) per active row, 0 off the
    frontier; the warm-settle prologue and per-pass cache misses."""
    return row_pass(MODE_COUNTS, segptr, nbr, core, thresholds, active)[0]


def fused_counts_plain(core, thresholds, active, segptr, nbr):
    return row_pass_plain(MODE_COUNTS, segptr, nbr, core, thresholds,
                          active)[0]
