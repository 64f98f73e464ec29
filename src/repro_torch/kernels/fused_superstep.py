"""One decomposition superstep per call: the CUDA kernel pair and its plain
PyTorch version.

The counterpart of ``repro/kernels/fused_superstep.py`` (``fused_pass``,
``fused_hindex``, ``fused_counts``): the same outputs with the same
meaning, in int32, over the flat CSR table of the device-resident
structure (``segptr`` (n+1,), ``nbr`` (E,)).  The CSR must be undirected
(every edge in both endpoint lists), as every ``CSRGraph`` is: the push
pass relies on that symmetry.

A superstep is two calls of ``csrc/fused_superstep.cu``:

* ``row_pass`` (phase 0): per active row, the capped h-index of the
  pass-start neighbour cores and the refreshed cnt at h, or a count at a
  given threshold; ``upd = #(active & deg > 0 & h != core)``;
* ``push_pass`` (phase 1, semicore* and semicore+): each active row whose
  core changed pushes cnt decrements (semicore*) or touched marks
  (semicore+) to its neighbours; then the next frontier (the reference's
  frontier ops after the pass) is built in the same call.

Each call is a sweep over the rows (one thread a row: pass-through values,
rows with work appended to the list of their degree bin) and kernels that
walk the lists, sized to the card, each list up to a count that stays in
device memory.  :func:`degree_bin` is the bin rule (mirrored in the
source, whose constants the wrapper checks when it loads the library);
:func:`bin_plan` lays the lists out from the degrees, once per structure
(``resident.ResidentStructure.bin_plan``) or per call.

The wrappers run the kernels for CUDA tensors and the plain version for
CPU tensors; there is no other route.  ``*_plain`` runs the plain version
on any device (the card's parity checks use it).  ``LAUNCHES`` counts the
calls of each wrapper that launch its kernels.
"""
from __future__ import annotations

import bisect
import ctypes
import functools

import torch

__all__ = [
    "LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE",
    "fused_pass", "fused_hindex", "fused_counts",
    "fused_pass_plain", "fused_hindex_plain", "fused_counts_plain",
    "row_pass", "push_pass", "row_pass_plain", "push_pass_plain",
    "MODE_HINDEX", "MODE_COUNTS", "MODE_SEMICORE", "MODE_SEMICORE_PLUS",
    "MODE_SEMICORE_STAR", "GROUP_LANES", "GROUP_MAX_DEG", "WARP_MAX_DEG",
    "HIST_BINS", "BINS", "BIN_FIRST_DEGREE", "degree_bin", "bin_plan",
    "check_bin_rule",
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

# the bin rule; the values are the CUDA source's (kGroupLanes, kGroupMaxDeg,
# kWarpMaxDeg, kHistBins)
GROUP_LANES = 8      # lanes a row in bin 0
GROUP_MAX_DEG = 32   # bin 0: degrees 1..32, GROUP_LANES lanes a row
WARP_MAX_DEG = 512   # bin 1: 33..512, a warp a row
HIST_BINS = 8192     # bin 2: 513..8191, a block a row, shared histogram
#                      bin 3: >= 8192, a block a row; probe loop if cap does
#                      not fit HIST_BINS
BINS = 4
#: the smallest degree of each bin
BIN_FIRST_DEGREE = (1, GROUP_MAX_DEG + 1, WARP_MAX_DEG + 1, HIST_BINS)

#: wrapper calls that launched their kernels, counted where they launch
LAUNCHES = {"row_pass": 0, "push_pass": 0}

_INT32_LIMIT = 1 << 31


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -------------------------------------------------------------- bin rule
def degree_bin(deg):
    """The kernels' bin of a row of degree ``deg`` (an int, or a tensor of
    them): -1 for an edgeless row (no bin: the sweep handles it), else the
    bin whose first degree (:data:`BIN_FIRST_DEGREE`) is the largest not
    above ``deg``.  The source's ``degree_bin``."""
    if isinstance(deg, torch.Tensor):
        first = torch.tensor(BIN_FIRST_DEGREE, dtype=deg.dtype,
                             device=deg.device)
        return torch.bucketize(deg, first, right=True) - 1
    return bisect.bisect_right(BIN_FIRST_DEGREE, int(deg)) - 1


def bin_plan(segptr: torch.Tensor) -> torch.Tensor:
    """(BINS + 1,) int32 on ``segptr``'s device: where each bin's work list
    starts in a buffer of n entries, i.e. the prefix sums of the rows of
    each bin (a list never holds more rows than its bin has).  Device ops
    only: nothing is read on the host."""
    deg = segptr[1:] - segptr[:-1]
    bins = degree_bin(deg)
    plan = torch.zeros(BINS + 1, dtype=torch.int32, device=segptr.device)
    pops = torch.stack([(bins == b).sum() for b in range(BINS)])
    torch.cumsum(pops, 0, dtype=torch.int32, out=plan[1:])
    return plan


def check_bin_rule(got) -> None:
    """Raise unless the source's (kGroupLanes, kGroupMaxDeg, kWarpMaxDeg,
    kHistBins) equal the rule of :func:`degree_bin`."""
    want = (GROUP_LANES, GROUP_MAX_DEG, WARP_MAX_DEG, HIST_BINS)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/fused_superstep.cu's bin rule (lanes, "
                           f"group, warp, histogram) {tuple(got)} differs "
                           f"from the wrapper's {want}")


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
        lib.fs_bin_rule.argtypes = [vp]
        lib.fs_bin_rule.restype = None
        lib.fs_row_pass.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp, vp, vp,
                                    vp, vp]
        lib.fs_row_pass.restype = i
        lib.fs_push_pass.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp, vp,
                                     vp, vp, vp]
        lib.fs_push_pass.restype = i
        rule = (ctypes.c_int * 4)()
        lib.fs_bin_rule(rule)
        check_bin_rule(list(rule))
        lib._repro_sigs = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_aligned(**tensors) -> None:
    """The sweeps move 8 rows of node state a thread in 16-byte words: the
    node arrays must start on 16 bytes (fresh tensors do; views may not)."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the CUDA kernels (got a view at "
                             f"{t.data_ptr() % 16} bytes past one)")


def _work(segptr, n, plan):
    """The plan (checked, or built from the degrees), the list buffer
    (row, first edge, end: 3 n entries) and the zeroed counters (BINS list
    fills, then upd)."""
    if plan is None:
        plan = bin_plan(segptr)
    elif (plan.dtype != torch.int32 or tuple(plan.shape) != (BINS + 1,)
          or plan.device != segptr.device):
        raise ValueError(f"plan must be int32 ({BINS + 1},) on "
                         f"{segptr.device}")
    lists = torch.empty(3 * n, dtype=torch.int32, device=segptr.device)
    counters = torch.zeros(BINS + 1, dtype=torch.int32, device=segptr.device)
    return plan, lists, counters


def _row_pass_cuda(mode, segptr, nbr, core, aux, active, plan):
    n = _check(segptr, nbr, core, aux, active)
    out_a = torch.empty_like(core)
    out_b = torch.empty_like(core) \
        if mode in (MODE_HINDEX, MODE_SEMICORE_STAR) else None
    _check_aligned(core=core, aux=aux, active=active)
    plan, lists, counters = _work(segptr, n, plan)
    if n:
        lib = _lib()
        with torch.cuda.device(core.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fs_row_pass(
                _ptr(segptr), _ptr(nbr), _ptr(core), _ptr(aux), _ptr(active),
                n, mode, _ptr(out_a), _ptr(out_b), _ptr(plan), _ptr(lists),
                _ptr(counters), stream)
        LAUNCHES["row_pass"] += 1
        if err:
            raise RuntimeError(f"row_pass launch failed: CUDA error {err}")
    return out_a, out_b, counters[BINS]


def _push_pass_cuda(mode, segptr, nbr, core, core2, active, target, plan):
    n = _check(segptr, nbr, core, None, active, core2, target)
    _check_aligned(core=core, active=active, core2=core2, target=target)
    active2 = torch.empty_like(active)
    if n:
        plan, lists, counters = _work(segptr, n, plan)
        lib = _lib()
        with torch.cuda.device(core.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fs_push_pass(
                _ptr(segptr), _ptr(nbr), _ptr(core), _ptr(core2),
                _ptr(active), n, mode, _ptr(target), _ptr(active2),
                _ptr(plan), _ptr(lists), _ptr(counters), stream)
        LAUNCHES["push_pass"] += 1
        if err:
            raise RuntimeError(f"push_pass launch failed: CUDA error {err}")
    return active2


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
    """The push pass in plain torch ops; updates ``target`` in place and
    returns the next frontier: ``(target < core2) & (core2 > 0)`` for
    semicore* (target = cnt2), ``(target > 0) & (core2 > 0)`` for
    semicore+ (target = touched marks)."""
    _check(segptr, nbr, core, None, active, core2, target)
    rows, _ = _rows(segptr, nbr)
    pushing = (active & (core2 != core))[rows]
    u = nbr[pushing]
    if mode == MODE_SEMICORE_STAR:
        v = rows[pushing]
        c2 = core2[u]
        dst = u[(c2 > core2[v]) & (c2 <= core[v])]
        target.index_add_(0, dst, torch.full_like(dst, -1))
        return (target < core2) & (core2 > 0)
    target[u] = 1
    return (target > 0) & (core2 > 0)


# ----------------------------------------------------------- dispatch
def row_pass(mode, segptr, nbr, core, aux, active, *, plan=None):
    """Row pass: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors.  ``plan`` is :func:`bin_plan` of ``segptr`` (built here
    when None); the plain version needs none."""
    if core.device.type == "cuda":
        return _row_pass_cuda(mode, segptr, nbr, core, aux, active, plan)
    if core.device.type == "cpu":
        return row_pass_plain(mode, segptr, nbr, core, aux, active)
    raise ValueError(f"no fused superstep for device {core.device}")


def push_pass(mode, segptr, nbr, core, core2, active, target, *, plan=None):
    """Push pass: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors (``plan`` as for :func:`row_pass`).  Updates ``target`` in
    place and returns the next frontier (:func:`push_pass_plain`)."""
    if core.device.type == "cuda":
        return _push_pass_cuda(mode, segptr, nbr, core, core2, active, target,
                               plan)
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
        return core2, cnt, pp(mode, segptr, nbr, core, core2, active,
                              touched), upd
    return core2, cnt2, pp(mode, segptr, nbr, core, core2, active, cnt2), upd


def fused_pass(core, cnt, active, segptr, nbr, *, algorithm: str, plan=None):
    """One engine superstep.

    ``core``/``cnt`` int32 (n,), ``active`` bool (n,).  Returns
    ``(core2, cnt2, active2, upd)`` with the semantics of the reference
    ``fused_pass``: ``cnt``/``active`` pass through for algorithms that do
    not track them, ``upd`` is a 0-dim int32 tensor on the device.
    ``plan``: :func:`bin_plan` of ``segptr``, built per call when None.
    """
    if plan is None and core.device.type == "cuda":
        plan = bin_plan(segptr)  # one plan for both passes
    return _superstep(functools.partial(row_pass, plan=plan),
                      functools.partial(push_pass, plan=plan), core, cnt,
                      active, segptr, nbr, algorithm)


def fused_pass_plain(core, cnt, active, segptr, nbr, *, algorithm: str):
    """:func:`fused_pass` through the plain version on any device."""
    return _superstep(row_pass_plain, push_pass_plain, core, cnt, active,
                      segptr, nbr, algorithm)


def fused_hindex(core, active, segptr, nbr, *, plan=None):
    """Per-pass path: ``(h, cnt_at_h)`` for the frontier in one row pass —
    ``h`` the cap-bounded h-index of the pass-start neighbour cores,
    ``cnt_at_h`` the refreshed #(nbr core >= h); both 0 off the frontier."""
    h, c, _ = row_pass(MODE_HINDEX, segptr, nbr, core, None, active,
                       plan=plan)
    return h, c


def fused_hindex_plain(core, active, segptr, nbr):
    h, c, _ = row_pass_plain(MODE_HINDEX, segptr, nbr, core, None, active)
    return h, c


def fused_counts(core, thresholds, active, segptr, nbr, *, plan=None):
    """#(nbr pass-start core >= threshold) per active row, 0 off the
    frontier; the warm-settle prologue and per-pass cache misses."""
    return row_pass(MODE_COUNTS, segptr, nbr, core, thresholds, active,
                    plan=plan)[0]


def fused_counts_plain(core, thresholds, active, segptr, nbr):
    return row_pass_plain(MODE_COUNTS, segptr, nbr, core, thresholds,
                          active)[0]
