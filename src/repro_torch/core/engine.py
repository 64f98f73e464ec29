"""Schedule-agnostic superstep engine: one pass-planner, pluggable compute.

The port's counterpart of ``repro/core/engine.py``:

* :class:`PassPlanner` owns everything about a pass that is not arithmetic:
  frontier selection and all :class:`BlockReader` I/O accounting.  Its
  accounting does not depend on the backend, so every backend reports the
  same ``edge_block_reads`` / ``node_table_reads`` for the same run.
* :class:`ComputeBackend` is the arithmetic: ``h_index`` (LocalCore, Eq. 1,
  capped at the old value), ``compute_cnt`` (Eq. 2) and ``push_decrements``
  (the UpdateNbrCnt push rule), all exact over integers.
* Shared ops: :func:`edge_ge_counts` and :func:`hindex_bsearch` over a
  pluggable ``segment_sum_fn`` — the per-probe superstep both the
  ``torch`` backend and the per-probe mode of the ``cuda`` backend run.
* Backends: :class:`NumpyBackend` (the vectorized host reference),
  :class:`CudaBackend` (the hand-written kernels, counterpart of the
  reference's ``PallasBackend``: the fused superstep of
  ``kernels/fused_superstep.py``, or with ``fused=False`` one block-skipping
  ``kernels/segsum_active`` launch per probe) and
  :class:`TorchBackend` (plain torch prefix sums, counterpart of
  ``XLABackend``).  Device backends run the whole fixpoint device-resident
  (``resident.run_resident``) unless ``REPRO_TORCH_DEVICE_RESIDENT=0``
  selects the per-pass loop below.  :class:`ShardedBackend` cuts the edge
  table into contiguous node-range shards over a list of devices and runs
  the fused superstep on every shard (``resident.run_sharded``); it has
  no per-pass loop.

Device backends run on ``cuda:0`` unless given another device; asking for
the default device without a GPU raises (``device="cpu"`` runs the kernels'
plain versions on the host, as the CPU tests do).
"""
from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import runtime as _runtime
from ..obs import metrics as _metrics, trace as _trace
from .localcore import h_index_batch, compute_cnt_batch

__all__ = [
    "DecompResult",
    "PassPlanner",
    "ComputeBackend",
    "NumpyBackend",
    "DeviceBackend",
    "CudaBackend",
    "TorchBackend",
    "ShardedBackend",
    "edge_ge_counts",
    "hindex_bsearch",
    "resolve_backend",
    "resolve_device",
    "run_batch",
    "warm_settle",
]

# Registry mirrors of the kernel-block tallies, incremented at the same
# sites as the backend's own counters (begin_pass here, the frontier replay
# in resident.py) so deltas reconcile with DecompResult.kernel_blocks_*.
_KB_ACTIVE = _metrics.counter(
    "repro_kernel_blocks_active_total",
    "Kernel blocks holding a frontier row's edges, summed over passes",
).labels()
_KB_SKIPPED = _metrics.counter(
    "repro_kernel_blocks_skipped_total",
    "Kernel blocks skipped by the frontier activity mask",
).labels()

_MAINT_PROLOGUE = _metrics.histogram(
    "repro_maintenance_cnt_prologue_seconds",
    "Exact-cnt full-scan prologue cost of warm settles (Eq. 2 over all nodes)",
)


def _pass_obs(algorithm: str, backend_name: str, schedule: str = "batch"):
    """The per-pass counter series (passes, frontier nodes, core updates)
    for one (algorithm, backend, schedule)."""
    lab = dict(algorithm=algorithm, backend=backend_name, schedule=schedule)
    return (
        _metrics.counter(
            "repro_engine_passes_total",
            "Supersteps executed (== DecompResult.iterations per run)",
        ).labels(**lab),
        _metrics.counter(
            "repro_engine_frontier_nodes_total",
            "Nodes recomputed, summed over passes (== node_computations)",
        ).labels(**lab),
        _metrics.counter(
            "repro_engine_updates_total",
            "Core-value updates, summed over passes",
        ).labels(**lab),
    )


def _kernel_counts(backend) -> tuple:
    return (getattr(backend, "kernel_blocks_active", 0),
            getattr(backend, "kernel_blocks_skipped", 0))


def _finish_pass_span(sp, backend, c_old_f, changed, ka0, ks0) -> None:
    """Attach pass args: updates, binary-search probe depth and kernel
    block activity."""
    cmax = int(c_old_f.max()) if len(c_old_f) else 0
    sp.set(updates=int(changed),
           hindex_probes=int(np.ceil(np.log2(cmax + 2))) if cmax else 0)
    ka1, ks1 = _kernel_counts(backend)
    if (ka1 - ka0) or (ks1 - ks0):
        sp.set(kernel_blocks_active=ka1 - ka0,
               kernel_blocks_skipped=ks1 - ks0)


@dataclass
class DecompResult:
    core: np.ndarray
    cnt: np.ndarray | None
    iterations: int
    node_computations: int
    edge_block_reads: int
    node_table_reads: int
    algorithm: str
    schedule: str
    updates_per_iter: list = field(default_factory=list)
    computations_per_iter: list = field(default_factory=list)
    backend: str = "numpy"
    # device backends: per-pass kernel-block activity at the accounting
    # block size; active + skipped = kernel blocks summed over passes
    kernel_blocks_active: int = 0
    kernel_blocks_skipped: int = 0
    # shard backend only: the number of shards and the padding cost of the
    # reference's rectangular (S, E) shard layout (slots wasted by padding
    # every shard to the heaviest one's edge count)
    num_shards: int = 0
    shard_pad_edges: int = 0

    @property
    def kmax(self) -> int:
        return int(self.core.max()) if len(self.core) else 0

    @property
    def memory_bytes(self) -> int:
        """O(n) node-state bytes held in memory (the paper's bound)."""
        per_node = 8 + (8 if self.cnt is not None else 0) + 1
        return len(self.core) * per_node


def resolve_device(device=None) -> torch.device:
    """``None`` means the first GPU, and raises without one: the port never
    falls back to the CPU unasked.  Any explicit device passes through."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU (cuda:0) by default and CUDA is "
                "not available here; pass device='cpu' to run the kernels' "
                "plain versions on the host")
        return torch.device("cuda", 0)
    return torch.device(device)


# ===========================================================================
# Shared ops (the per-probe superstep of the torch and per-probe cuda paths)
# ===========================================================================
def edge_ge_counts(nbr_vals, rows, edge_mask, thresholds, num_segments,
                   *, segment_sum_fn):
    """#{edges e : nbr_vals[e] >= thresholds[rows[e]]} per segment (Eq. 2).

    ``segment_sum_fn(vals, rows, num_segments)`` selects the reduction
    substrate; ``edge_mask`` (None: every edge) drops edges from the count.
    """
    ok = nbr_vals >= thresholds[rows]
    if edge_mask is not None:
        ok &= edge_mask
    return segment_sum_fn(ok.to(torch.int32), rows, num_segments)


def hindex_bsearch(nbr_vals, rows, edge_mask, c_old, num_probes,
                   *, segment_sum_fn):
    """Vectorized binary search for h = max k <= c_old with count_ge(k) >= k.

    Exactly LocalCore (Eq. 1) capped at ``c_old``: count_ge is
    non-increasing in k, so the predicate is monotone and ``num_probes``
    segment sums (>= bit length of max c_old) converge to
    ``min(h_index, c_old)``.  Every probe runs, converged or not, as the
    reference's ``fori_loop`` does.
    """
    num_rows = c_old.shape[0]
    lo = torch.zeros_like(c_old)
    hi = c_old
    for _ in range(num_probes):
        mid = (lo + hi + 1) // 2
        cnt = edge_ge_counts(nbr_vals, rows, edge_mask, mid, num_rows,
                             segment_sum_fn=segment_sum_fn)
        ok = (cnt >= mid) & (mid > 0)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo


def _num_probes(cmax: int) -> int:
    """Binary-search probes that resolve any h in [0, cmax]."""
    return int(np.ceil(np.log2(cmax + 2)))


# ===========================================================================
# Compute backends
# ===========================================================================
class ComputeBackend:
    """Arithmetic of one superstep over flattened CSR segments.

    ``vals``/``seg_ptr`` follow the ``PassPlanner.gather`` layout: ``vals``
    holds the neighbour core values of the P frontier nodes segment by
    segment, ``seg_ptr`` the (P+1,) offsets.
    """

    name = "abstract"
    # whether the backend reads the gathered (vals, seg_ptr) arrays; a
    # full-table backend skips the host gather where only the charge counts
    consumes_gather = True
    # device backends run the whole fixpoint device-resident (resident.py)
    device_resident = False

    def bind(self, planner: "PassPlanner") -> None:
        """Called once per run, before the first pass."""

    def unbind(self) -> None:
        """Called when a run's result is built; drop any bound working set."""

    def begin_pass(self, frontier: np.ndarray, core: np.ndarray) -> None:
        """Called at the start of every pass with the frontier node ids and
        the pass-start core array."""

    def io_report(self) -> dict:
        """Backend-side I/O effects (kernel blocks)."""
        return {}

    def h_index(self, vals, seg_ptr, c_old) -> np.ndarray:
        """min(h-index of each segment, c_old) — LocalCore (Eq. 1)."""
        raise NotImplementedError

    def compute_cnt(self, vals, seg_ptr, thresholds) -> np.ndarray:
        """#{u in segment : vals(u) >= threshold(segment)} — Eq. 2."""
        raise NotImplementedError

    def push_decrements(self, nbr_flat: np.ndarray, seg_ptr: np.ndarray,
                        h: np.ndarray, c_old: np.ndarray, core: np.ndarray,
                        n: int) -> np.ndarray:
        """UpdateNbrCnt push rule: dec[u] = #{edges (v -> u) in the frontier
        adjacency : core_now(u) in (h(v), c_old(v)]}, on the host (cnt is
        in-memory node state; no edge I/O is involved)."""
        lens = np.diff(seg_ptr)
        h_rep = np.repeat(h, lens)
        c_old_rep = np.repeat(c_old, lens)
        core_now_u = core[nbr_flat]
        mask = (core_now_u > h_rep) & (core_now_u <= c_old_rep)
        if mask.any():
            return np.bincount(nbr_flat[mask].astype(np.int64), minlength=n)
        return np.zeros(n, dtype=np.int64)


class NumpyBackend(ComputeBackend):
    """The vectorized host reference (localcore.py)."""

    name = "numpy"

    def h_index(self, vals, seg_ptr, c_old):
        return np.minimum(h_index_batch(vals, seg_ptr), c_old)

    def compute_cnt(self, vals, seg_ptr, thresholds):
        return compute_cnt_batch(vals, seg_ptr, thresholds)


class DeviceBackend(ComputeBackend):
    """Device residency shared by the device backends.

    The flat merged edge table is built and uploaded once per *graph
    version* — a :class:`~repro_torch.core.resident.ResidentStructure` keyed
    by base-CSR identity plus ``BufferedGraph.version`` — and reused across
    runs and supersteps.  ``retain_structure=False`` (the default) drops it
    when a result is built, so a one-shot ``decompose`` keeps no O(m) copy.

    :meth:`resident_ops` gives ``run_resident`` the backend's superstep and
    its Eq. 2 count; ``reports_kernel_blocks`` says whether runs account
    kernel-block activity (``kernel_blocks_*``; 0 otherwise).
    """

    device_resident = True
    retain_structure = False
    reports_kernel_blocks = False

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._resident = None
        self.structure_builds = 0  # cache-miss counter

    def resident_ops(self, rs, block_edges: int, num_probes: int) -> tuple:
        """``(step, counts)`` of a resident run over ``rs``:
        ``step(core, cnt, active, segptr, nbr, *, algorithm)`` returns
        ``(core2, cnt2, active2, upd)`` and ``counts(core, thresholds,
        active, segptr, nbr)`` the Eq. 2 counts of the active rows."""
        raise NotImplementedError

    def bind_resident(self, planner: "PassPlanner"):
        """The resident working set for the planner's current graph
        version; cached, rebuilt only on structural change."""
        from .resident import build_structure

        planner.eng._sync()
        rs = self._resident
        if rs is not None and rs.matches(planner):
            return rs
        with _trace.span("resident.structure", cat="engine",
                         backend=self.name, nodes=planner.n):
            rs = build_structure(planner, self.device)
        self.structure_builds += 1
        self._resident = rs
        return rs

    def release_resident(self) -> None:
        if not self.retain_structure:
            self._resident = None

    def unbind(self):
        self.release_resident()


class CudaBackend(DeviceBackend):
    """The hand-written kernels (counterpart of the reference's
    ``PallasBackend``).

    ``fused=True`` (the default) runs one ``fused_pass`` (row pass + push
    pass) per superstep.  ``fused=False`` runs the per-probe superstep
    (``resident.probe_ops``): ``num_probes`` h-index probes plus one count,
    each one block-skipping ``segment_sum_active`` launch
    over the pass's block flags — the parity oracle of the fused kernels.

    The default path runs the whole fixpoint device-resident
    (``resident.run_resident``).  The per-pass methods below serve the
    ``REPRO_TORCH_DEVICE_RESIDENT=0`` loop: fused, one ``fused_hindex``
    launch per pass returns ``(h, cnt_at_h)`` and the SemiCore* pass's
    ``compute_cnt(thresholds == h)`` is served from a per-pass cache; per
    probe, ``h_index`` and ``compute_cnt`` each run their segment sums.

    Kernel-block accounting replays the frontier's edge spans at
    ``min(reader.block_edges, 512)`` edges per block, as the reference's
    pallas backend does, so ``kernel_blocks_active``/``skipped`` match it;
    the per-probe kernels decide block activity at that same size.

    ``plain=True`` runs the fused kernels' plain torch versions on the
    backend's device instead: the yardstick the card's parity checks
    compare with (it has no per-probe mode).
    """

    name = "cuda"
    consumes_gather = False  # scans its own resident full table
    reports_kernel_blocks = True

    def __init__(self, *, device=None, block_edges: int | None = None,
                 plain: bool = False, fused: bool = True):
        super().__init__(device)
        from ..kernels import fused_superstep as fsk

        self.block_edges = block_edges
        self.plain = bool(plain)
        if self.plain:
            if fused is False:
                raise ValueError("plain=True runs the fused kernels' plain "
                                 "versions; there is no plain per-probe mode")
            self.fused = True
            self.name = "cuda-plain"
            self.fused_pass = fsk.fused_pass_plain
            self.fused_hindex = fsk.fused_hindex_plain
            self.fused_counts = fsk.fused_counts_plain
        else:
            self.fused = bool(fused)
            self.fused_pass = fsk.fused_pass
            self.fused_hindex = fsk.fused_hindex
            self.fused_counts = fsk.fused_counts
        self.kernel_blocks_active = 0
        self.kernel_blocks_skipped = 0

    def accounting_block_edges(self, planner) -> int:
        be = self.block_edges or min(planner.reader.block_edges, 512)
        return max(1, int(be))

    def resident_ops(self, rs, block_edges, num_probes):
        if self.fused:
            if self.plain:
                return self.fused_pass, self.fused_counts
            # the kernels' work-list layout, once per structure
            plan = rs.bin_plan()
            return (functools.partial(self.fused_pass, plan=plan),
                    functools.partial(self.fused_counts, plan=plan))
        from .resident import probe_ops

        return probe_ops("cuda", rs, block_edges, num_probes)

    # -- lifecycle ----------------------------------------------------------
    def bind(self, planner):
        self.kernel_blocks_active = 0
        self.kernel_blocks_skipped = 0
        rs = self.bind_resident(planner)
        self.n = planner.n
        self.E = rs.E
        self.seg_ptr = rs.seg_ptr  # flat-table offsets, for block coverage
        self.be = self.accounting_block_edges(planner)
        self.nb = -(-max(rs.E, 1) // self.be)

    def unbind(self):
        for attr in ("seg_ptr", "_core0", "_active", "_frontier",
                     "_cnt_cache", "_segsum"):
            if hasattr(self, attr):
                delattr(self, attr)
        self.release_resident()

    def begin_pass(self, frontier, core):
        self._cnt_cache = None  # (thresholds, cnt) from the h_index launch
        self._segsum = None  # the pass's per-probe segment sum, built once
        self._core0 = torch.as_tensor(
            np.asarray(core, dtype=np.int32), device=self.device)
        self._frontier = np.asarray(frontier, dtype=np.int64)
        active = np.zeros(self.n, dtype=bool)
        active[self._frontier] = True
        self._active = torch.as_tensor(active, device=self.device)
        if self.E:
            # a kernel block is active iff some frontier node's edge span
            # covers it
            lo = self.seg_ptr[self._frontier]
            hi = self.seg_ptr[self._frontier + 1]
            nz = lo < hi
            cov = np.zeros(self.nb + 1, dtype=np.int64)
            if nz.any():
                np.add.at(cov, lo[nz] // self.be, 1)
                np.add.at(cov, (hi[nz] - 1) // self.be + 1, -1)
            na = int((np.cumsum(cov[:-1]) > 0).sum())
            self.kernel_blocks_active += na
            self.kernel_blocks_skipped += self.nb - na
            _KB_ACTIVE.inc(na)
            _KB_SKIPPED.inc(self.nb - na)

    def io_report(self):
        return {
            "kernel_blocks_active": self.kernel_blocks_active,
            "kernel_blocks_skipped": self.kernel_blocks_skipped,
        }

    # -- per-pass ops over the resident table ---------------------------------
    def _frontier_table(self, x) -> torch.Tensor:
        """(n,) int32 device array: ``x`` on the frontier, 0 elsewhere."""
        full = np.zeros(self.n, dtype=np.int32)
        full[self._frontier] = x
        return torch.as_tensor(full, device=self.device)

    def _probe_segsum(self):
        """The pass's block-skipping segment sum (flags from the frontier,
        at the accounting block size), built at its first use in a pass and
        shared by the pass's ``h_index`` and ``compute_cnt``."""
        if self._segsum is None:
            from .resident import _substrate

            self._segsum = _substrate("cuda", self.be)(
                self._resident.rows(), self._resident.segptr, self._active,
                self.n)
        return self._segsum

    def h_index(self, vals, seg_ptr, c_old):
        F = len(self._frontier)
        c_old = np.asarray(c_old, dtype=np.int64)
        cmax = int(c_old.max()) if F else 0
        if F == 0 or cmax == 0 or self.E == 0:
            return np.zeros(F, dtype=np.int64)
        if not self.fused:
            nbr = self._resident.edge_table()[1]
            h = hindex_bsearch(
                self._core0[nbr], self._resident.rows(), None,
                self._frontier_table(c_old), _num_probes(cmax),
                segment_sum_fn=self._probe_segsum())
            return h.cpu().numpy().astype(np.int64)[self._frontier]
        h_t, cnth_t = self.fused_hindex(self._core0, self._active,
                                        *self._resident.edge_table())
        h = h_t.cpu().numpy().astype(np.int64)[self._frontier]
        self._cnt_cache = (
            h, cnth_t.cpu().numpy().astype(np.int64)[self._frontier])
        return h

    def compute_cnt(self, vals, seg_ptr, thresholds):
        F = len(self._frontier)
        if F == 0 or self.E == 0:
            return np.zeros(F, dtype=np.int64)
        if not self.fused:
            nbr = self._resident.edge_table()[1]
            cnt = edge_ge_counts(self._core0[nbr], self._resident.rows(),
                                 None, self._frontier_table(thresholds),
                                 self.n, segment_sum_fn=self._probe_segsum())
            return cnt.cpu().numpy().astype(np.int64)[self._frontier]
        cache = self._cnt_cache
        if cache is not None and np.array_equal(
                cache[0], np.asarray(thresholds, dtype=np.int64)):
            return cache[1]
        cnt = self.fused_counts(self._core0, self._frontier_table(thresholds),
                                self._active, *self._resident.edge_table())
        return cnt.cpu().numpy().astype(np.int64)[self._frontier]


class TorchBackend(DeviceBackend):
    """The per-probe superstep in plain torch ops over sorted prefix sums
    (counterpart of the reference's ``XLABackend``): the shared
    :func:`edge_ge_counts` / :func:`hindex_bsearch` with
    ``resident._sorted_segsum`` as the reduction, no kernel of the port.

    The default path is device-resident (``resident.run_resident``).  The
    per-pass methods below serve ``REPRO_TORCH_DEVICE_RESIDENT=0``: they
    upload the host-gathered frontier segments (exact length; the
    reference's power-of-two padding only bounds jit recompiles) and reduce
    them on the device.  A SemiCore* pass's ``h_index`` and ``compute_cnt``
    get the same arrays, packed once.  It reports no kernel blocks.
    """

    name = "torch"

    def __init__(self, *, device=None):
        super().__init__(device)
        # one-slot memo: (vals, seg_ptr, packed device arrays)
        self._pack_memo: tuple | None = None

    def resident_ops(self, rs, block_edges, num_probes):
        from .resident import probe_ops

        return probe_ops("torch", rs, block_edges, num_probes)

    def _pack(self, vals, seg_ptr):
        """(vals, rows, segment sum) of the gathered segments on the
        device."""
        from .resident import _sorted_segsum

        memo = self._pack_memo
        if memo is not None and memo[0] is vals and memo[1] is seg_ptr:
            return memo[2]
        if len(vals) >= (1 << 31):
            raise ValueError(f"{len(vals)} gathered edges exceed the int32 "
                             "range of the torch backend")
        dev = self.device
        lens = torch.as_tensor(np.diff(seg_ptr), device=dev)
        rows = torch.repeat_interleave(
            torch.arange(len(lens), dtype=torch.int32, device=dev), lens,
            output_size=len(vals))
        apply_ = _sorted_segsum(torch.as_tensor(
            np.asarray(seg_ptr, dtype=np.int32), device=dev))
        packed = (torch.as_tensor(np.asarray(vals, dtype=np.int32),
                                  device=dev), rows,
                  lambda v, _rows, _ns: apply_(v))
        self._pack_memo = (vals, seg_ptr, packed)
        return packed

    def unbind(self):
        self._pack_memo = None
        self.release_resident()

    def h_index(self, vals, seg_ptr, c_old):
        P = len(seg_ptr) - 1
        c_old = np.asarray(c_old, dtype=np.int64)
        cmax = int(c_old.max()) if P else 0
        if P == 0 or len(vals) == 0 or cmax == 0:
            return np.zeros(P, dtype=np.int64)
        v, rows, segsum = self._pack(vals, seg_ptr)
        h = hindex_bsearch(
            v, rows, None,
            torch.as_tensor(c_old.astype(np.int32), device=self.device),
            _num_probes(cmax), segment_sum_fn=segsum)
        return h.cpu().numpy().astype(np.int64)

    def compute_cnt(self, vals, seg_ptr, thresholds):
        P = len(seg_ptr) - 1
        if P == 0 or len(vals) == 0:
            return np.zeros(P, dtype=np.int64)
        v, rows, segsum = self._pack(vals, seg_ptr)
        thr = torch.as_tensor(np.asarray(thresholds, dtype=np.int32),
                              device=self.device)
        cnt = edge_ge_counts(v, rows, None, thr, P, segment_sum_fn=segsum)
        return cnt.cpu().numpy().astype(np.int64)


def _indexed(device) -> torch.device:
    """``device`` as a torch.device, ``"cuda"`` with its index made
    explicit (so one card listed two ways is one device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class ShardedBackend(DeviceBackend):
    """The shard substrate: the paper's semi-external contract over a list
    of devices (counterpart of the reference's mesh ``ShardedBackend``).

    Edge shards never move: ``distributed.shard_layout`` cuts the merged
    flat table into contiguous node ranges minimax-balanced by edge count,
    so every owned node's complete adjacency is local.  Each shard is an
    ordinary table of the fused superstep kernels, of full length n: its
    rows outside its range are empty.  Node state (``core``) is replicated
    O(n) per distinct device.  A superstep (``resident.run_sharded``) runs
    ``row_pass`` on every shard from the pass-start core, gathers the owned
    slices into one post-update core per device (the one gather a
    superstep), runs ``push_pass`` on every shard against it and sums the
    shards' frontier counts.  The planner's I/O trace is replayed on the
    host from the per-chunk owned frontier slices, so the shard backend
    walks the numpy backend's exact passes at every shard count.

    ``devices`` lists the shards' devices and may repeat one (several
    shards on one card, or on the CPU); ``None`` takes every visible GPU
    and raises without one.  ``num_shards`` (``None``: one a listed device)
    may not exceed the list's length.  ``plain=True`` runs the fused
    kernels' plain torch versions on the listed devices: the yardstick the
    card's parity checks compare with.  The bound
    :class:`~repro_torch.core.resident.ShardedStructure` is cached per
    base-CSR version like the flat resident table.  There is no per-pass
    host loop (``requires_resident``), and no CPU fallback: a CUDA device
    runs the kernels or raises.
    """

    name = "shard"
    consumes_gather = False
    mesh_sharded = True       # run_resident dispatches to run_sharded
    requires_resident = True  # no per-pass loop exists for this one

    def __init__(self, num_shards: int | None = None, devices=None,
                 plain: bool = False):
        from ..kernels import fused_superstep as fsk

        if devices is None:
            first = resolve_device(None)  # raises without a GPU
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())] or [first]
        self.devices = [_indexed(d) for d in devices]
        if not self.devices:
            raise ValueError("shard backend: the device list is empty")
        super().__init__(self.devices[0])
        self.num_shards = None if num_shards is None else int(num_shards)
        self.plain = bool(plain)
        if self.plain:
            self.name = "shard-plain"
            self.row_pass = lambda *a, plan=None: fsk.row_pass_plain(*a)
            self.push_pass = lambda *a, plan=None: fsk.push_pass_plain(*a)
        else:
            self.row_pass = fsk.row_pass
            self.push_pass = fsk.push_pass

    def resolve_shards(self) -> int:
        avail = len(self.devices)
        S = avail if self.num_shards is None else self.num_shards
        if not 1 <= S <= avail:
            raise ValueError(
                f"shard backend: num_shards={S} but only {avail} device(s) "
                "are listed; list a device once per shard (it may repeat, "
                "e.g. devices=[cuda:0] * S) or lower CoreGraphConfig."
                "num_shards / REPRO_TORCH_NUM_SHARDS")
        return S

    def bind_resident(self, planner: "PassPlanner"):
        from .resident import build_sharded_structure

        planner.eng._sync()
        S = self.resolve_shards()
        ss = self._resident
        if ss is not None and ss.S == S and ss.matches(planner):
            return ss
        with _trace.span("resident.structure", cat="engine",
                         backend=self.name, nodes=planner.n, shards=S):
            ss = build_sharded_structure(planner, S, self.devices[:S])
        self.structure_builds += 1
        self._resident = ss
        return ss

    def gather(self, ss, core2_parts) -> dict:
        """The superstep's one gather: each shard's owned slice of its
        post-update core copied into one (n,) core per distinct device
        (a peer copy between cards, a slice copy within one)."""
        out = {}
        for dev in ss.devices:
            full = torch.empty(ss.n, dtype=torch.int32, device=dev)
            for t, part in zip(ss.shards, core2_parts):
                full[t.lo:t.hi].copy_(part[t.lo:t.hi])
            out[dev] = full
        return out

    def superstep(self, ss, core, cnt, active, *, algorithm, cand=None):
        """One superstep over every shard.

        ``core`` maps each device to its replicated (n,) int32 pass-start
        core; ``cnt`` and ``active`` hold one (n,) array per shard, only
        its owned rows meaningful (``active`` False elsewhere).  Returns
        ``(core2, cnt2, active2, upd, nact)`` in the same layout; ``upd``
        (rows whose core changed, counted on the gathered core as the
        reference's shard does) and ``nact`` (next frontier size) are 0-dim
        int32 on the first device.  ``cand`` (one owned mask a shard)
        confines the next frontier (the masked settle)."""
        from ..kernels import fused_superstep as fsk

        mode = fsk._ALGORITHM_MODE[algorithm]
        star = mode == fsk.MODE_SEMICORE_STAR
        parts = [self.row_pass(mode, t.segptr, t.nbr, core[t.device],
                               cnt[i] if star else None, active[i],
                               plan=t.plan)
                 for i, t in enumerate(ss.shards)]
        core2 = self.gather(ss, [p[0] for p in parts])
        d0 = ss.devices[0]
        upd = (core2[d0] != core[d0]).sum(dtype=torch.int32)
        if mode == fsk.MODE_SEMICORE:
            return core2, cnt, active, upd, None
        cnt2, active2 = [], []
        for i, t in enumerate(ss.shards):
            target = parts[i][1] if star else torch.zeros_like(core[t.device])
            a2 = self.push_pass(mode, t.in_segptr, t.in_nbr, core[t.device],
                                core2[t.device], t.every_row, target,
                                plan=t.in_plan)
            active2.append(a2 & (t.owned if cand is None else cand[i]))
            cnt2.append(target if star else None)
        nact = sum(a.sum(dtype=torch.int32).to(d0) for a in active2)
        return core2, cnt2 if star else cnt, active2, upd, nact

    def counts(self, ss, core) -> list:
        """The warm settle's Eq. 2 prologue on every shard: #(nbr core >=
        core) of each owned row (one ``fused_counts`` row pass a shard)."""
        from ..kernels import fused_superstep as fsk

        return [self.row_pass(fsk.MODE_COUNTS, t.segptr, t.nbr,
                              core[t.device], core[t.device], t.owned,
                              plan=t.plan)[0]
                for t in ss.shards]


def resolve_backend(backend=None, device=None, *,
                    num_shards: int | None = None) -> ComputeBackend:
    """Backend instance passthrough, or by name (``"cuda"`` | ``"torch"`` |
    ``"shard"`` | ``"numpy"``); ``None`` resolves ``REPRO_TORCH_BACKEND``
    (default ``"cuda"``), as the reference's ``resolve_backend`` does.
    ``device`` places a named device backend; for ``"shard"`` it is the
    device of every shard (``None``: one shard a visible GPU), and
    ``num_shards`` (else ``REPRO_TORCH_NUM_SHARDS``, the reference's
    ``REPRO_NUM_SHARDS``) the number of shards."""
    if isinstance(backend, ComputeBackend):
        return backend
    name = str(backend if backend is not None
               else _runtime.setting("backend"))
    if name == "numpy":
        return NumpyBackend()
    if name == "cuda":
        return CudaBackend(device=device)
    if name == "torch":
        return TorchBackend(device=device)
    if name == "shard":
        if num_shards is None:
            ns = os.environ.get("REPRO_TORCH_NUM_SHARDS")
            num_shards = int(ns) if ns else None
        devices = None if device is None else [device] * (num_shards or 1)
        return ShardedBackend(num_shards=num_shards, devices=devices)
    raise ValueError(f"unknown compute backend {name!r}")


# ===========================================================================
# Pass planner: frontier / I/O accounting
# ===========================================================================
class PassPlanner:
    """Owns the I/O side of a pass over blocked storage: gather a frontier's
    flattened adjacency (charging exact block I/O) and account a node-table
    scan over the frontier's id range.  Compute never touches the reader."""

    def __init__(self, engine):
        self.eng = engine

    @property
    def reader(self):
        return self.eng.reader

    @property
    def n(self) -> int:
        return self.eng.n

    def _segments(self, nodes: np.ndarray):
        """Flattened raw-CSR adjacency of ``nodes`` (no I/O charge, no
        buffered-delta merge): (nbr_flat, seg_ptr, lo, hi)."""
        g = self.eng.graph
        lo = g.indptr[nodes]
        hi = g.indptr[nodes + 1]
        lens = (hi - lo).astype(np.int64)
        total = int(lens.sum())
        seg_ptr = np.zeros(len(nodes) + 1, dtype=np.int64)
        np.cumsum(lens, out=seg_ptr[1:])
        if total:
            flat = np.repeat(lo - seg_ptr[:-1], lens) + np.arange(
                total, dtype=np.int64)
            nbr_flat = np.asarray(g.adj)[flat]
        else:
            nbr_flat = np.empty(0, dtype=np.int32)
        return nbr_flat, seg_ptr, lo, hi

    def _merge_buffered(self, nodes, nbr_flat, seg_ptr):
        """Splice buffered edge deltas into the flattened segments (no extra
        block I/O), rebuilding only the dirty nodes' segments."""
        buffered = self.eng.buffered
        if buffered is None or not buffered._size:
            return nbr_flat, seg_ptr
        dirty = np.fromiter(
            buffered._ins.keys() | buffered._del.keys(), dtype=np.int64)
        hit = np.flatnonzero(np.isin(nodes, dirty))
        if not len(hit):
            return nbr_flat, seg_ptr
        merged = [
            np.asarray(buffered.merged_neighbors(
                int(nodes[i]), nbr_flat[seg_ptr[i]: seg_ptr[i + 1]]),
                dtype=np.int32)
            for i in hit
        ]
        new_lens = np.diff(seg_ptr)
        new_lens[hit] = [len(s) for s in merged]
        new_ptr = np.zeros(len(nodes) + 1, dtype=np.int64)
        np.cumsum(new_lens, out=new_ptr[1:])
        out = np.empty(int(new_ptr[-1]), dtype=np.int32)
        prev_old = 0
        prev_new = 0
        for seg, i in zip(merged, hit):
            span = int(seg_ptr[i]) - prev_old  # untouched run before i
            out[prev_new: prev_new + span] = nbr_flat[prev_old: prev_old + span]
            prev_new += span
            out[prev_new: prev_new + len(seg)] = seg
            prev_new += len(seg)
            prev_old = int(seg_ptr[i + 1])
        out[prev_new:] = nbr_flat[prev_old:]
        return out, new_ptr

    def full_structure(self):
        """Merged flat adjacency of *all* nodes, charge-free: the device
        backend's resident working set (disk I/O stays per pass)."""
        self.eng._sync()
        nodes = np.arange(self.n, dtype=np.int64)
        nbr_flat, seg_ptr, _, _ = self._segments(nodes)
        return self._merge_buffered(nodes, nbr_flat, seg_ptr)[:2]

    def charge_blocks(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Charge one pass over the union of [lo//B, (hi-1)//B] block
        intervals, streamed through the reader's buffer pool in order."""
        reader = self.reader
        B = reader.block_edges
        nz = (hi - lo) > 0
        if nz.any():
            first = (lo[nz] // B).astype(np.int64)
            last = ((hi[nz] - 1) // B).astype(np.int64)
            diff = np.zeros(reader.num_blocks + 1, dtype=np.int64)
            np.add.at(diff, first, 1)
            np.add.at(diff, last + 1, -1)
            covered = np.cumsum(diff[:-1]) > 0
            reader.charge_pass(np.flatnonzero(covered))

    def gather(self, nodes: np.ndarray, core: np.ndarray):
        """Flattened adjacency of ``nodes`` + exact block-I/O accounting:
        (neighbour core values, segment offsets, flat neighbour ids)."""
        self.eng._sync()
        nbr_flat, seg_ptr, lo, hi = self._segments(nodes)
        self.charge_blocks(lo, hi)
        nbr_flat, seg_ptr = self._merge_buffered(nodes, nbr_flat, seg_ptr)
        return core[nbr_flat], seg_ptr, nbr_flat

    def charge_only(self, nodes: np.ndarray) -> None:
        """The I/O charge of :meth:`gather` without materializing the
        adjacency."""
        self.eng._sync()
        g = self.eng.graph
        self.charge_blocks(g.indptr[nodes], g.indptr[nodes + 1])

    def gather_structure(self, nodes: np.ndarray):
        """Like :meth:`gather` without the neighbour values:
        (seg_ptr, nbr_flat)."""
        self.eng._sync()
        nbr_flat, seg_ptr, lo, hi = self._segments(nodes)
        self.charge_blocks(lo, hi)
        nbr_flat, seg_ptr = self._merge_buffered(nodes, nbr_flat, seg_ptr)
        return seg_ptr, nbr_flat

    def account_node_scan(self, v_lo: int, v_hi: int) -> None:
        self.reader.account_node_table_scan(v_lo, v_hi)


# ===========================================================================
# The generic batch superstep loop (Jacobi; one superstep == one pass)
# ===========================================================================
def resident_on(engine, backend) -> bool:
    """Whether ``backend`` settles in the device-resident fixpoint:
    a device backend, unless ``REPRO_TORCH_DEVICE_RESIDENT=0`` or, with
    that unset, the ``device_resident`` of ``engine``'s Settings says no;
    always for a backend with no per-pass loop (``requires_resident``)."""
    if getattr(backend, "requires_resident", False):
        return True
    settings = getattr(engine, "settings", None)
    return backend.device_resident and _runtime.setting(
        "device_resident", None if settings is None
        else settings.device_resident)


def run_batch(engine, algorithm: str, backend=None, *,
              core: np.ndarray | None = None,
              cnt: np.ndarray | None = None,
              rebind: bool = True,
              superstep_chunk: int | None = None,
              device=None) -> DecompResult:
    """Run a batch-schedule decomposition on ``engine`` with ``backend``.

    * ``semicore``   — every node, every pass (Alg. 3);
    * ``semicore+``  — neighbours of changed nodes (Alg. 4 / Lemma 4.1);
    * ``semicore*``  — cnt-gated: recompute v only while cnt(v) < core(v)
      (Alg. 5 / Lemma 4.2), with exact cnt under simultaneous updates.

    With (core, cnt) given for ``semicore*``, runs the warm-started settle.
    ``rebind=False`` continues on a backend the caller already bound.
    Device backends run the device-resident fixpoint (resident.py) unless
    ``REPRO_TORCH_DEVICE_RESIDENT=0``.
    """
    backend = resolve_backend(backend, device)
    if rebind and resident_on(engine, backend):
        from .resident import run_resident

        return run_resident(engine, algorithm, backend, core=core, cnt=cnt,
                            superstep_chunk=superstep_chunk)
    planner = engine.planner
    n = engine.n
    if rebind:
        backend.bind(planner)
    comp, iters = 0, 0
    upd_hist: list = []
    comp_hist: list = []

    if algorithm == "semicore":
        core = engine.degrees().astype(np.int64)
        all_nodes = np.arange(n, dtype=np.int64)
        om_p, om_f, om_u = _pass_obs("semicore", backend.name)
        while True:
            iters += 1
            with _trace.span("superstep", cat="engine", algorithm="semicore",
                             backend=backend.name, index=iters,
                             frontier=n) as sp:
                ka0, ks0 = _kernel_counts(backend)
                backend.begin_pass(all_nodes, core)
                if backend.consumes_gather:
                    vals, seg_ptr, _ = planner.gather(all_nodes, core)
                else:  # full-table backend; this loop only needs the charge
                    planner.charge_only(all_nodes)
                    vals = seg_ptr = None
                planner.account_node_scan(0, n - 1)
                h = backend.h_index(vals, seg_ptr, core)
                changed = int((h != core).sum())
                if sp.active:
                    _finish_pass_span(sp, backend, core, changed, ka0, ks0)
            om_p.inc()
            om_f.inc(n)
            om_u.inc(changed)
            upd_hist.append(changed)
            comp_hist.append(n)
            comp += n
            core = h
            if changed == 0:
                break
        return _result(planner, backend, core, None, iters, comp,
                       "semicore", upd_hist, comp_hist)

    if algorithm == "semicore+":
        core = engine.degrees().astype(np.int64)
        frontier = np.arange(n, dtype=np.int64)
        om_p, om_f, om_u = _pass_obs("semicore+", backend.name)
        while len(frontier):
            iters += 1
            with _trace.span("superstep", cat="engine", algorithm="semicore+",
                             backend=backend.name, index=iters,
                             frontier=len(frontier)) as sp:
                ka0, ks0 = _kernel_counts(backend)
                backend.begin_pass(frontier, core)
                if backend.consumes_gather:
                    vals, seg_ptr, nbr_flat = planner.gather(frontier, core)
                else:  # structure only: propagation needs nbr_flat
                    seg_ptr, nbr_flat = planner.gather_structure(frontier)
                    vals = None
                planner.account_node_scan(int(frontier[0]), int(frontier[-1]))
                h = backend.h_index(vals, seg_ptr, core[frontier])
                changed_mask = h != core[frontier]
                if sp.active:
                    _finish_pass_span(sp, backend, core[frontier],
                                      changed_mask.sum(), ka0, ks0)
            om_p.inc()
            om_f.inc(len(frontier))
            om_u.inc(int(changed_mask.sum()))
            comp += len(frontier)
            comp_hist.append(len(frontier))
            upd_hist.append(int(changed_mask.sum()))
            core[frontier] = h
            # Lemma 4.1: only neighbours of changed nodes can change next pass
            seg_changed = np.repeat(changed_mask, np.diff(seg_ptr))
            frontier = np.unique(nbr_flat[seg_changed].astype(np.int64))
            frontier = frontier[core[frontier] > 0]
        return _result(planner, backend, core, None, iters, comp,
                       "semicore+", upd_hist, comp_hist)

    if algorithm == "semicore*":
        if core is None:
            core = engine.degrees().astype(np.int64)
            cnt = np.zeros(n, dtype=np.int64)
        else:
            core = np.asarray(core, dtype=np.int64).copy()
            cnt = np.asarray(cnt, dtype=np.int64).copy()
        frontier = np.flatnonzero((cnt < core) & (core > 0))
        om_p, om_f, om_u = _pass_obs("semicore*", backend.name)
        while len(frontier):
            iters += 1
            with _trace.span("superstep", cat="engine", algorithm="semicore*",
                             backend=backend.name, index=iters,
                             frontier=len(frontier)) as sp:
                ka0, ks0 = _kernel_counts(backend)
                backend.begin_pass(frontier, core)
                if backend.consumes_gather:
                    vals_old, seg_ptr, nbr_flat = planner.gather(frontier, core)
                else:  # structure only: push rule needs nbr_flat
                    seg_ptr, nbr_flat = planner.gather_structure(frontier)
                    vals_old = None
                planner.account_node_scan(int(frontier[0]), int(frontier[-1]))
                c_old_f = core[frontier].copy()
                h = backend.h_index(vals_old, seg_ptr, c_old_f)
                if sp.active:
                    _finish_pass_span(sp, backend, c_old_f,
                                      (h != c_old_f).sum(), ka0, ks0)
            om_p.inc()
            om_f.inc(len(frontier))
            om_u.inc(int((h != c_old_f).sum()))
            comp += len(frontier)
            comp_hist.append(len(frontier))
            upd_hist.append(int((h != c_old_f).sum()))
            core[frontier] = h
            # exact cnt under simultaneous updates: (1) recompute the
            # frontier's cnt against pass-start neighbour values, (2) push
            # decrements along edges (v in F -> u) with core(u) in (h, c_old]
            cnt[frontier] = backend.compute_cnt(vals_old, seg_ptr, h)
            cnt -= backend.push_decrements(nbr_flat, seg_ptr, h, c_old_f,
                                           core, n)
            frontier = np.flatnonzero((cnt < core) & (core > 0))
        return _result(planner, backend, core, cnt, iters, comp,
                       "semicore*", upd_hist, comp_hist)

    raise ValueError(f"unknown algorithm {algorithm!r}")


def warm_settle(engine, core0: np.ndarray, applied_inserts: int,
                backend=None, *, superstep_chunk: int | None = None,
                device=None) -> DecompResult:
    """Settle to the exact decomposition from a stale ``core0`` after
    structural updates.

    ``min(core0 + I, deg)`` — I the number of applied insertions — bounds
    the new decomposition from above.  One full scan recomputes cnt exactly
    against it (Eq. 2), then SemiCore* batch passes converge from above
    (Thm 4.1) to the exact fixpoint.
    """
    backend = resolve_backend(backend, device)
    n = engine.n
    warm = np.minimum(
        np.asarray(core0, dtype=np.int64) + int(applied_inserts),
        engine.degrees(),
    ).astype(np.int64)
    if resident_on(engine, backend):
        from .resident import run_resident

        return run_resident(engine, "semicore*", backend, core=warm,
                            initial_cnt_scan=True,
                            superstep_chunk=superstep_chunk)
    backend.bind(engine.planner)
    all_nodes = np.arange(n, dtype=np.int64)
    t0 = time.perf_counter()
    with _trace.span("cnt_prologue", cat="maintenance",
                     backend=backend.name, nodes=n):
        backend.begin_pass(all_nodes, warm)
        if backend.consumes_gather:
            vals, seg_ptr, _ = engine.planner.gather(all_nodes, warm)
        else:  # full-table backend scans its own resident copy
            engine.planner.charge_only(all_nodes)
            vals = seg_ptr = None
        engine.planner.account_node_scan(0, n - 1)
        cnt = backend.compute_cnt(vals, seg_ptr, warm)
    _MAINT_PROLOGUE.observe(time.perf_counter() - t0)
    return run_batch(engine, "semicore*", backend, core=warm, cnt=cnt,
                     rebind=False)


def _result(planner, backend, core, cnt, iters, comp, algo, upd, cph
            ) -> DecompResult:
    rep = backend.io_report()
    backend.unbind()
    return DecompResult(
        core=core,
        cnt=cnt,
        iterations=iters,
        node_computations=comp,
        edge_block_reads=planner.reader.reads,
        node_table_reads=planner.reader.node_table_reads,
        algorithm=algo,
        schedule="batch",
        updates_per_iter=upd,
        computations_per_iter=cph,
        backend=backend.name,
        kernel_blocks_active=rep.get("kernel_blocks_active", 0),
        kernel_blocks_skipped=rep.get("kernel_blocks_skipped", 0),
    )
