"""Device-resident fixpoint: the whole batch superstep loop on the device.

The port's counterpart of ``repro/core/resident.py`` (its flat path):

* **Residency** — ``core``, ``cnt``, the frontier mask and the flat edge
  table (``segptr``, ``nbr``) are uploaded once per run; the edge table is
  cached in a :class:`ResidentStructure` keyed by base-CSR identity plus
  ``BufferedGraph.version``.
* **One superstep per step** — the backend's ``resident_ops``: the row
  pass and push pass of ``kernels/fused_superstep.py`` (``cuda``), or the
  per-probe superstep of :func:`probe_ops` — ``num_probes`` h-index probes
  and the cnt refresh, each one segment sum over the pass's substrate
  (:func:`_substrate`: the block-skipping kernels for ``cuda`` with
  ``fused=False``, sorted prefix sums for ``torch``).  The reference's
  ``lax.scan`` of ``lax.cond``-gated passes becomes a Python loop of
  ``chunk`` passes whose ``ran``/``done`` flags and stacked frontier masks
  stay on the device; the host reads them once per chunk.  A pass whose
  frontier is empty (or, for SemiCore, that runs after convergence) sees
  every row inactive: the rows pass their state through (the per-probe
  kernels read no block), so it changes nothing, as the reference's
  skipped ``cond`` branch.
* **Accounting parity** — the host replays each executed pass's frontier
  through the planner charges the per-pass path makes (edge-block
  coverage, node-table scans, kernel-block activity), so
  ``edge_block_reads`` / ``node_table_reads`` / ``kernel_blocks_*`` equal
  the reference's bit for bit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import runtime as _runtime
from ..obs import metrics as _metrics, trace as _trace
from .engine import (DecompResult, _KB_ACTIVE, _KB_SKIPPED, _MAINT_PROLOGUE,
                     _num_probes, _pass_obs)

__all__ = [
    "ResidentStructure",
    "ShardedStructure",
    "ShardTable",
    "build_structure",
    "build_sharded_structure",
    "run_sharded",
    "probe_ops",
    "run_resident",
    "chunk_len",
]

_HOST_SYNCS = _metrics.counter(
    "repro_resident_host_syncs_total",
    "Device-to-host reads of a chunk's pass summaries (one per chunk)",
).labels()


def chunk_len(explicit: int | None = None) -> int:
    """Passes per host round-trip: explicit argument > env > default."""
    if explicit is not None:
        return max(1, int(explicit))
    return _runtime.setting("resident_chunk")


# ===========================================================================
# Resident structure: the flat merged edge table, uploaded once per version
# ===========================================================================
@dataclass
class ResidentStructure:
    """The device-resident working set of one graph version.

    The host ``seg_ptr`` stays for the accounting replay; ``graph`` and
    ``version`` form the validity token.  ``nbr`` is padded with node id 0
    up to ``E_pad``; every reduction is bounded by ``segptr``, and the
    kernels get the exact-length view, so a pad never reaches node 0.
    """

    graph: object            # base CSRGraph this structure was built from
    version: int             # BufferedGraph.version at build time (0 if none)
    n: int
    E: int                   # merged flat edge count (buffered deltas applied)
    E_pad: int               # padded device length (>= E)
    seg_ptr: np.ndarray      # (n+1,) int64 flat-table offsets, host
    segptr: torch.Tensor     # (n+1,) int32 device flat-table offsets
    nbr: torch.Tensor        # (E_pad,) int32 device edge targets (pad: 0)
    device: torch.device
    _rows: torch.Tensor | None = None  # (E,) int32 edge sources, on demand
    _bin_plan: torch.Tensor | None = None  # fused kernels' list layout

    def matches(self, planner) -> bool:
        buffered = planner.eng.buffered
        ver = buffered.version if buffered is not None else 0
        return self.graph is planner.eng.graph and self.version == ver

    def edge_table(self) -> tuple:
        """(segptr, nbr) device operands of the superstep kernels, ``nbr``
        as the exact-length view."""
        return self.segptr, self.nbr[:self.E]

    def rows(self) -> torch.Tensor:
        """(E,) int32 device row (source node) of every edge slot, sorted;
        built on first use and kept for this graph version (the per-probe
        superstep's segment ids)."""
        if self._rows is None:
            deg = self.segptr[1:] - self.segptr[:-1]
            self._rows = torch.repeat_interleave(
                torch.arange(self.n, dtype=torch.int32, device=self.device),
                deg, output_size=self.E)
        return self._rows

    def bin_plan(self) -> torch.Tensor:
        """The fused superstep kernels' work-list layout by degree bin
        (``kernels.fused_superstep.bin_plan``): degrees are fixed for a
        graph version, so it is built on first use and kept."""
        if self._bin_plan is None:
            from ..kernels.fused_superstep import bin_plan

            self._bin_plan = bin_plan(self.segptr)
        return self._bin_plan


_EDGE_BUCKET = 8192


def _edge_pad(E: int) -> int:
    """Device-table length for ``E`` edge slots: next power of two below one
    bucket, then bucket multiples, so the allocation only changes size when
    maintenance moves E across a bucket boundary."""
    if E <= 0:
        return 0
    if E < _EDGE_BUCKET:
        return 1 << (E - 1).bit_length()
    return -(-E // _EDGE_BUCKET) * _EDGE_BUCKET


def build_structure(planner, device) -> ResidentStructure:
    """Merged flat adjacency of all nodes, uploaded once (charge-free: disk
    I/O stays per pass, replayed planner-side)."""
    planner.eng._sync()
    nbr_flat, seg_ptr = planner.full_structure()
    n = planner.n
    E = int(len(nbr_flat))
    if E >= (1 << 31) or n >= (1 << 31):
        # the device table is int32 end to end (ids, offsets): fail loudly
        # instead of wrapping offsets negative
        raise ValueError(
            f"device-resident table needs int32 offsets: 2m={E} n={n} "
            "exceeds 2**31; use the numpy backend for this graph")
    if E and (int(nbr_flat.min()) < 0 or int(nbr_flat.max()) >= n):
        # torch (and the kernels) do not clip indices as jnp does
        raise ValueError(f"neighbour ids must lie in [0, {n})")
    E_pad = _edge_pad(E)
    nbr = torch.zeros(E_pad, dtype=torch.int32, device=device)
    nbr[:E] = torch.from_numpy(np.asarray(nbr_flat, dtype=np.int32))
    buffered = planner.eng.buffered
    return ResidentStructure(
        graph=planner.eng.graph,
        version=buffered.version if buffered is not None else 0,
        n=n,
        E=E,
        E_pad=E_pad,
        seg_ptr=np.asarray(seg_ptr, dtype=np.int64),
        segptr=torch.as_tensor(np.asarray(seg_ptr, dtype=np.int32),
                               device=device),
        nbr=nbr,
        device=torch.device(device),
    )


# ===========================================================================
# The per-probe superstep (cuda with fused=False, torch)
# ===========================================================================
def _sorted_segsum(segptr):
    """Segment sum over the table's *sorted* rows: prefix sum + boundary
    gathers, bounded by ``segptr`` (exact: integer cumsum, E < 2**31)."""
    def segsum(vals):
        cs = torch.zeros(vals.shape[0] + 1, dtype=vals.dtype,
                         device=vals.device)
        torch.cumsum(vals, 0, out=cs[1:])
        return cs[segptr[1:]] - cs[segptr[:-1]]

    return segsum


def _substrate(kind: str, block_edges: int):
    """``for_pass(rows, segptr, node_active, num_segments)`` -> the
    ``segment_sum_fn`` of one pass: the block-skipping kernels for
    ``"cuda"`` (block flags computed once per pass at ``block_edges``), the
    sorted prefix sums for ``"torch"``."""
    if kind == "cuda":
        from ..kernels.segsum_active import make_superstep_segsum

        def for_pass(rows, segptr, node_active, num_segments):
            apply_ = make_superstep_segsum(rows, node_active, num_segments,
                                           block_edges=block_edges)
            return lambda vals, _rows, _ns: apply_(vals)
    elif kind == "torch":
        def for_pass(rows, segptr, node_active, num_segments):
            apply_ = _sorted_segsum(segptr)
            return lambda vals, _rows, _ns: apply_(vals)
    else:
        raise ValueError(f"unknown segment-sum substrate {kind!r}")
    return for_pass


def probe_ops(kind: str, rs: ResidentStructure, block_edges: int,
              num_probes: int) -> tuple:
    """``(step, counts)`` of the per-probe superstep over ``rs``, with the
    signatures of ``fused_pass`` / ``fused_counts``.

    A pass gathers the pass-start neighbour cores once, binary-searches h
    in ``num_probes`` segment sums, refreshes cnt in one more (semicore*),
    and applies the push and touched rules as row sums over the sorted
    table: by the undirected symmetry, edge (v -> u) exists iff (u -> v)
    does, so no scatter along ``nbr`` is needed.
    """
    from .engine import edge_ge_counts, hindex_bsearch

    for_pass = _substrate(kind, block_edges)
    row_sum = _sorted_segsum(rs.segptr)
    rows = rs.rows()
    n = rs.n

    def step(core, cnt, active, segptr, nbr, *, algorithm):
        segsum = for_pass(rows, segptr, active, n)
        nbr_vals = core[nbr]  # pass-start
        c_old = torch.where(active, core, 0)
        h = hindex_bsearch(nbr_vals, rows, None, c_old, num_probes,
                           segment_sum_fn=segsum)
        changed = active & (h != core)
        upd = changed.sum(dtype=torch.int32)
        core2 = torch.where(active, h, core)
        if algorithm == "semicore":
            return core2, cnt, active, upd
        if algorithm == "semicore+":
            # u is next-frontier iff some neighbour changed: a row sum over
            # u's own segment
            touched = row_sum(changed[nbr].to(torch.int32))
            return core2, cnt, (touched > 0) & (core2 > 0), upd
        if algorithm != "semicore*":
            raise ValueError(f"unknown algorithm {algorithm!r}")
        # (1) recompute cnt of the frontier against pass-start values
        refreshed = edge_ge_counts(nbr_vals, rows, None,
                                   torch.where(active, h, 0), n,
                                   segment_sum_fn=segsum)
        # (2) push decrements: dec[u] = #{edges (v in F -> u) : core_now(u)
        #     in (h(v), c_old(v)]}, summed over u's own segment, v = nbr[e]
        c2_row = core2[rows]
        push = active[nbr] & (c2_row > h[nbr]) & (c2_row <= nbr_vals)
        cnt2 = torch.where(active, refreshed, cnt) - row_sum(
            push.to(torch.int32))
        return core2, cnt2, (cnt2 < core2) & (core2 > 0), upd

    def counts(core, thresholds, active, segptr, nbr):
        return edge_ge_counts(core[nbr], rows, None, thresholds, n,
                              segment_sum_fn=for_pass(rows, segptr, active,
                                                      n))

    return step, counts


# ===========================================================================
# Host-side accounting replay
# ===========================================================================
def _replay_kernel_blocks(tally: dict | None, rs: ResidentStructure,
                          be: int, nb: int, frontier: np.ndarray) -> None:
    """Kernel-block activity of one pass over ``frontier``: the per-pass
    ``begin_pass`` coverage formula over the flat table, verbatim (an
    edgeless table has no kernel blocks to charge; a backend that reports
    none passes no tally)."""
    if tally is None or not len(frontier) or rs.E == 0:
        return
    lo = rs.seg_ptr[frontier]
    hi = rs.seg_ptr[frontier + 1]
    nz = lo < hi
    cov = np.zeros(nb + 1, dtype=np.int64)
    if nz.any():
        np.add.at(cov, lo[nz] // be, 1)
        np.add.at(cov, (hi[nz] - 1) // be + 1, -1)
    na = int((np.cumsum(cov[:-1]) > 0).sum())
    tally["kernel_blocks_active"] += na
    tally["kernel_blocks_skipped"] += nb - na
    _KB_ACTIVE.inc(na)
    _KB_SKIPPED.inc(nb - na)


def _replay_pass(planner, frontier: np.ndarray, tally: dict | None,
                 rs: ResidentStructure, be: int, nb: int) -> None:
    """Re-issue the planner charges one per-pass iteration makes for
    ``frontier`` (sorted node ids)."""
    if not len(frontier):
        return
    planner.charge_only(frontier)
    planner.account_node_scan(int(frontier[0]), int(frontier[-1]))
    _replay_kernel_blocks(tally, rs, be, nb, frontier)


def _replay_chunk(planner, rs, be, nb, tally, fronts, upds, ran,
                  upd_hist, comp_hist, iters, comp, om=None, algorithm=""):
    """Replay the planner charges for the executed passes of one chunk;
    trace instants come from the same frontier masks."""
    for k in range(len(ran)):
        if not ran[k]:
            break
        frontier = np.flatnonzero(fronts[k]).astype(np.int64)
        iters += 1
        comp += len(frontier)
        upd_hist.append(int(upds[k]))
        comp_hist.append(int(len(frontier)))
        _replay_pass(planner, frontier, tally, rs, be, nb)
        if om is not None:
            om[0].inc()
            om[1].inc(len(frontier))
            om[2].inc(int(upds[k]))
        _trace.instant("superstep.replay", cat="engine", algorithm=algorithm,
                       index=iters, frontier=int(len(frontier)),
                       updates=int(upds[k]))
    return iters, comp


def _pull(fronts, upds, ran, done):
    """One chunk's summaries to the host: (frontier masks or None, updates,
    ran flags, done)."""
    _HOST_SYNCS.inc()
    summary = torch.stack(
        [*upds, *(r.to(torch.int32) for r in ran), done.to(torch.int32)]
    ).cpu().numpy()
    k = len(upds)
    masks = torch.stack(fronts).cpu().numpy() if fronts else None
    return masks, summary[:k], summary[k:2 * k].astype(bool), bool(summary[-1])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64)


# ===========================================================================
# The runner
# ===========================================================================
def run_resident(engine, algorithm: str, backend, *,
                 core: np.ndarray | None = None,
                 cnt: np.ndarray | None = None,
                 initial_cnt_scan: bool = False,
                 superstep_chunk: int | None = None,
                 max_supersteps: int | None = None,
                 settle_mask: np.ndarray | None = None) -> DecompResult:
    """Run a batch-schedule decomposition with the fixpoint device-resident.

    Mirrors :func:`engine.run_batch` pass for pass (same frontiers, same
    histories, same planner accounting).  With ``initial_cnt_scan`` (the
    warm-settle discipline) ``cnt`` is recomputed exactly on the device from
    the warm ``core`` upper bound — one accounted full scan — before the
    SemiCore* passes.

    ``settle_mask`` (semicore* only) freezes every node outside the mask:
    the frontier starts at ``(cnt < core) & (core > 0) & mask`` and stays
    inside it.  Frozen nodes keep their core; their cnt still takes exact
    push decrements from falling masked neighbours.

    A sharded backend (``ShardedBackend``) dispatches to
    :func:`run_sharded`: the same contract with the edge table cut into
    shards, plus the ``max_supersteps`` budget (the flat path refuses it).
    """
    if getattr(backend, "mesh_sharded", False):
        return run_sharded(engine, algorithm, backend, core=core, cnt=cnt,
                           initial_cnt_scan=initial_cnt_scan,
                           superstep_chunk=superstep_chunk,
                           max_supersteps=max_supersteps,
                           settle_mask=settle_mask)
    if max_supersteps is not None:
        raise ValueError("max_supersteps is only supported on the shard "
                         "backend (budgeted runs)")
    if settle_mask is not None and algorithm != "semicore*":
        raise ValueError("settle_mask is a semicore* (cnt-gated) discipline")

    planner = engine.planner
    n = engine.n
    rs = backend.bind_resident(planner)
    dev = rs.device
    # kernel-block accounting at the planner-derived block size (the
    # per-probe kernels decide block activity at the same size)
    if backend.reports_kernel_blocks:
        be = backend.accounting_block_edges(planner)
        nb = -(-max(rs.E, 1) // be)
        tally = {"kernel_blocks_active": 0, "kernel_blocks_skipped": 0}
    else:
        be = nb = 0
        tally = None
    chunk = chunk_len(superstep_chunk)
    om = _pass_obs(algorithm, backend.name)
    segptr, nbr = rs.edge_table()

    warm = core is not None
    if warm:
        core = np.asarray(core, dtype=np.int64).copy()
    else:
        core = engine.degrees().astype(np.int64)
    core_t = torch.as_tensor(core.astype(np.int32), device=dev)
    # probes of the per-probe superstep: enough for the largest core bound
    # of the run (cores only fall), as the reference fixes them per run
    step, counts = backend.resident_ops(
        rs, be, max(1, _num_probes(int(core.max()) if n else 0)))

    upd_hist: list = []
    comp_hist: list = []
    iters = 0
    comp = 0
    all_nodes = np.arange(n, dtype=np.int64)

    def result(core_f, cnt_f):
        backend.unbind()
        return DecompResult(
            core=_host(core_f),
            cnt=None if cnt_f is None else _host(cnt_f),
            iterations=iters,
            node_computations=comp,
            edge_block_reads=planner.reader.reads,
            node_table_reads=planner.reader.node_table_reads,
            algorithm=algorithm,
            schedule="batch",
            updates_per_iter=upd_hist,
            computations_per_iter=comp_hist,
            backend=backend.name,
            kernel_blocks_active=(tally or {}).get("kernel_blocks_active", 0),
            kernel_blocks_skipped=(tally or {}).get("kernel_blocks_skipped",
                                                    0),
        )

    def replay_all_nodes(upd: int) -> None:
        nonlocal iters, comp
        iters += 1
        comp += n
        upd_hist.append(upd)
        comp_hist.append(n)
        planner.charge_only(all_nodes)
        planner.account_node_scan(0, n - 1)
        _replay_kernel_blocks(tally, rs, be, nb, all_nodes)
        om[0].inc()
        om[1].inc(n)
        om[2].inc(upd)

    # ------------------------------------------------------------ semicore*
    if algorithm == "semicore*":
        if initial_cnt_scan:
            # warm_settle prologue: one accounted full scan recomputes cnt
            # exactly (Eq. 2) w.r.t. the warm upper bound, on the device
            t0 = time.perf_counter()
            with _trace.span("cnt_prologue", cat="maintenance",
                             backend=backend.name, nodes=n):
                planner.charge_only(all_nodes)
                planner.account_node_scan(0, n - 1)
                _replay_kernel_blocks(tally, rs, be, nb, all_nodes)
                if rs.E:
                    all_active = torch.ones(n, dtype=torch.bool, device=dev)
                    cnt_t = counts(core_t, core_t, all_active, segptr, nbr)
                else:
                    cnt_t = torch.zeros(n, dtype=torch.int32, device=dev)
                cnt = _host(cnt_t)
            _MAINT_PROLOGUE.observe(time.perf_counter() - t0)
        elif warm:
            cnt = np.asarray(cnt, dtype=np.int64).copy()
            cnt_t = torch.as_tensor(cnt.astype(np.int32), device=dev)
        else:
            cnt = np.zeros(n, dtype=np.int64)
            cnt_t = torch.zeros(n, dtype=torch.int32, device=dev)
        active0 = (cnt < core) & (core > 0)
        if settle_mask is not None:
            active0 &= np.asarray(settle_mask, dtype=bool)
        if rs.E == 0:
            # edgeless table: any deficient node drops straight to h = 0 in
            # one pass, and nothing can re-activate — numpy's loop verbatim
            if active0.any():
                f = np.flatnonzero(active0)
                iters, comp = 1, len(f)
                upd = int((core[f] != 0).sum())
                upd_hist.append(upd)
                comp_hist.append(len(f))
                _replay_pass(planner, f, tally, rs, be, nb)
                om[0].inc()
                om[1].inc(len(f))
                om[2].inc(upd)
                core[f] = 0
                cnt[f] = 0
            return result(core, cnt)
        if not active0.any():
            # settled warm state: zero passes, like numpy's while-loop
            return result(core, cnt)
        cand_t = None if settle_mask is None else torch.as_tensor(
            np.asarray(settle_mask, dtype=bool), device=dev)
        active_t = torch.as_tensor(active0, device=dev)
        while True:
            with _trace.span("resident.chunk", cat="engine",
                             algorithm="semicore*", backend=backend.name,
                             chunk=chunk) as sp:
                fronts, upds, ran = [], [], []
                for _ in range(chunk):
                    fronts.append(active_t)
                    ran.append(active_t.any())
                    core_t, cnt_t, active_t, upd = step(
                        core_t, cnt_t, active_t, segptr, nbr,
                        algorithm="semicore*")
                    if cand_t is not None:
                        active_t = active_t & cand_t
                    upds.append(upd)
                masks, upds_h, ran_h, done = _pull(fronts, upds, ran,
                                                   ~active_t.any())
                iters, comp = _replay_chunk(
                    planner, rs, be, nb, tally, masks, upds_h, ran_h,
                    upd_hist, comp_hist, iters, comp, om, "semicore*")
                if sp.active:
                    sp.set(passes_run=int(ran_h.sum()))
            if done:
                break
        return result(core_t, cnt_t)

    # ------------------------------------------------- semicore / semicore+
    if algorithm not in ("semicore", "semicore+"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if rs.E == 0:
        # h == core == degrees == 0 everywhere: one all-node pass converges
        # (semicore runs it even on an empty graph, as numpy's loop does)
        if algorithm == "semicore" or n:
            replay_all_nodes(0)
        return result(core, None)

    if algorithm == "semicore":
        # every node, every pass — the final no-update pass included; once
        # done, the pass sees no row active and changes nothing
        done_t = torch.zeros((), dtype=torch.bool, device=dev)
        while True:
            with _trace.span("resident.chunk", cat="engine",
                             algorithm="semicore", backend=backend.name,
                             chunk=chunk) as sp:
                upds, ran = [], []
                for _ in range(chunk):
                    running = ~done_t
                    ran.append(running)
                    core_t, _, _, upd = step(
                        core_t, core_t, running.expand(n).contiguous(),
                        segptr, nbr, algorithm="semicore")
                    done_t = upd == 0
                    upds.append(upd)
                _, upds_h, ran_h, done = _pull([], upds, ran, done_t)
                for k in range(len(ran_h)):
                    if not ran_h[k]:
                        break
                    replay_all_nodes(int(upds_h[k]))
                    _trace.instant("superstep.replay", cat="engine",
                                   algorithm="semicore", index=iters,
                                   frontier=n, updates=int(upds_h[k]))
                if sp.active:
                    sp.set(passes_run=int(ran_h.sum()))
            if done:
                break
        return result(core_t, None)

    active_t = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        with _trace.span("resident.chunk", cat="engine",
                         algorithm="semicore+", backend=backend.name,
                         chunk=chunk) as sp:
            fronts, upds, ran = [], [], []
            for _ in range(chunk):
                fronts.append(active_t)
                ran.append(active_t.any())
                core_t, _, active_t, upd = step(
                    core_t, None, active_t, segptr, nbr,
                    algorithm="semicore+")
                upds.append(upd)
            masks, upds_h, ran_h, done = _pull(fronts, upds, ran,
                                               ~active_t.any())
            iters, comp = _replay_chunk(
                planner, rs, be, nb, tally, masks, upds_h, ran_h, upd_hist,
                comp_hist, iters, comp, om, "semicore+")
            if sp.active:
                sp.set(passes_run=int(ran_h.sum()))
        if done:
            break
    return result(core_t, None)



# ===========================================================================
# Sharded execution (the `shard` backend)
# ===========================================================================
@dataclass
class ShardTable:
    """One shard's device tables: two ordinary fused-superstep tables of
    full length n over the shard's owned range ``[lo, hi)``.

    * ``segptr``/``nbr`` — the shard's rows: empty outside ``[lo, hi)``,
      neighbours as global ids (the row pass's table);
    * ``in_segptr``/``in_nbr`` — the edges *into* the owned range: every
      row's neighbours that lie in ``[lo, hi)`` (by the CSR's symmetry,
      the transpose of the shard's rows, as many edges; the push pass's
      table, so a changed row anywhere pushes its decrements or marks
      into the owned rows that need them, and into no other).

    ``plan``/``in_plan`` are the kernels' work-list layouts (built once at
    bind), ``owned`` the (n,) mask of ``[lo, hi)``, ``every_row`` an all-True
    (n,) mask (the push pass's pushers: the rows whose core changed).
    """

    device: torch.device
    lo: int
    hi: int
    segptr: torch.Tensor     # (n+1,) int32
    nbr: torch.Tensor        # (E_s,) int32
    in_segptr: torch.Tensor  # (n+1,) int32
    in_nbr: torch.Tensor     # (E_s,) int32
    plan: torch.Tensor
    in_plan: torch.Tensor
    owned: torch.Tensor      # (n,) bool
    every_row: torch.Tensor  # (n,) bool


@dataclass
class ShardedStructure:
    """The sharded working set of one graph version.

    The merged flat adjacency is cut into contiguous node-range shards
    (``distributed.shard_layout``: minimax edge balance, int32-validated)
    and uploaded once per structural version — the version-keyed cache
    contract of :class:`ResidentStructure`.  The host fields are the
    reference's (``owned_ids_h``/``owned_mask_h``, the rectangular
    layout's ``pad_edges``, ``per_shard_edges``); the device side is one
    :class:`ShardTable` per shard that owns a node (``shards``; a shard
    with an empty range has none, and takes no part in a superstep).
    """

    graph: object            # base CSRGraph this structure was built from
    version: int             # BufferedGraph.version at build time (0 if none)
    n: int
    E: int                   # merged flat edge count (buffered deltas applied)
    S: int                   # number of shards
    V: int                   # owned-node slots per shard (padded)
    seg_ptr: np.ndarray      # (n+1,) int64 merged flat offsets, host
    bounds: np.ndarray       # (S+1,) int64 node-range cuts
    owned_ids_h: np.ndarray  # (S, V) int32 host — global id per slot (pad n)
    owned_mask_h: np.ndarray # (S, V) bool host
    pad_edges: int           # S * Emax - E (the rectangular layout's waste)
    per_shard_edges: np.ndarray  # (S,) int64
    devices: list            # the distinct devices, in first-shard order
    shards: list             # ShardTable per shard with nodes

    def matches(self, planner) -> bool:
        buffered = planner.eng.buffered
        ver = buffered.version if buffered is not None else 0
        return self.graph is planner.eng.graph and self.version == ver


def _shard_table(nbr_rows: np.ndarray, seg_ptr: np.ndarray, lo: int,
                 hi: int, device) -> ShardTable:
    """One shard's tables on ``device``, from its range's neighbours
    ``nbr_rows`` (the flat table's ``[seg_ptr[lo], seg_ptr[hi])``) and the
    global offsets: its rows uploaded, their transpose built there (a
    stable sort of the shard's edges by target), so a device holds only
    its shards' edges."""
    from ..kernels.fused_superstep import bin_plan

    n = len(seg_ptr) - 1
    e0, e1 = int(seg_ptr[lo]), int(seg_ptr[hi])
    segptr = torch.as_tensor((np.clip(seg_ptr, e0, e1) - e0).astype(
        np.int32)).to(device, copy=True)
    nbr = torch.as_tensor(np.ascontiguousarray(
        nbr_rows, dtype=np.int32)).to(device, copy=True)
    if lo == 0 and hi == n:
        # every row owned: the rows are their own transpose (symmetry)
        in_segptr, in_nbr = segptr, nbr
    else:
        rows = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=device),
            segptr[1:] - segptr[:-1], output_size=e1 - e0)
        in_nbr = rows[torch.argsort(nbr, stable=True)]
        del rows
        in_segptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
        torch.cumsum(torch.bincount(nbr, minlength=n), 0, dtype=torch.int32,
                     out=in_segptr[1:])
    owned = torch.zeros(n, dtype=torch.bool, device=device)
    owned[lo:hi] = True
    return ShardTable(
        device=torch.device(device), lo=lo, hi=hi, segptr=segptr, nbr=nbr,
        in_segptr=in_segptr, in_nbr=in_nbr, plan=bin_plan(segptr),
        in_plan=bin_plan(in_segptr), owned=owned,
        every_row=torch.ones(n, dtype=torch.bool, device=device))


def build_sharded_structure(planner, num_shards: int,
                            devices: list) -> ShardedStructure:
    """Merged flat adjacency of all nodes, cut into shards, each uploaded
    once to its device (``devices``: one a shard); charge-free, like
    :func:`build_structure` (disk I/O stays per pass, replayed
    planner-side)."""
    from .distributed import shard_layout

    planner.eng._sync()
    nbr_flat, seg_ptr = planner.full_structure()
    n = planner.n
    E = int(len(nbr_flat))
    lay = shard_layout(seg_ptr, num_shards, n)
    if E and (int(nbr_flat.min()) < 0 or int(nbr_flat.max()) >= n):
        raise ValueError(f"neighbour ids must lie in [0, {n})")
    S = int(lay["owned_ids"].shape[0])
    bounds = lay["bounds"]
    distinct = list(dict.fromkeys(torch.device(d) for d in devices[:S]))
    seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
    shards = [_shard_table(nbr_flat[seg_ptr[bounds[s]]:seg_ptr[bounds[s + 1]]],
                           seg_ptr, int(bounds[s]), int(bounds[s + 1]),
                           devices[s])
              for s in range(S) if bounds[s] < bounds[s + 1]]
    buffered = planner.eng.buffered
    return ShardedStructure(
        graph=planner.eng.graph,
        version=buffered.version if buffered is not None else 0,
        n=n,
        E=E,
        S=S,
        V=int(lay["owned_ids"].shape[1]),
        seg_ptr=seg_ptr,
        bounds=bounds,
        owned_ids_h=lay["owned_ids"],
        owned_mask_h=lay["owned_mask"],
        pad_edges=int(lay["pad_edges"]),
        per_shard_edges=lay["per_shard_edges"],
        devices=distinct,
        shards=shards,
    )


def build_rank_structure(planner, num_shards: int, rank: int,
                         device) -> ShardedStructure:
    """The shard of ``rank`` alone, for the shard backend over a process
    group: the cut (``distributed.shard_layout``) from the merged degree
    array, then only this rank's node range's adjacency read (a slice of
    the CSR, memmapped or not, with buffered deltas merged), uploaded to
    ``device``.  No rank reads the whole edge table."""
    from .distributed import shard_layout

    planner.eng._sync()
    n = planner.n
    seg_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(planner.eng.degrees(), out=seg_ptr[1:])
    lay = shard_layout(seg_ptr, num_shards, n)
    bounds = lay["bounds"]
    S = int(lay["owned_ids"].shape[0])
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    shards = []
    if lo < hi:
        g = planner.eng.graph
        e0, e1 = int(g.indptr[lo]), int(g.indptr[hi])
        rows = np.asarray(g.adj[e0:e1], dtype=np.int32)
        local = np.asarray(g.indptr[lo:hi + 1], dtype=np.int64) - e0
        rows, _ = planner._merge_buffered(np.arange(lo, hi, dtype=np.int64),
                                          rows, local)
        if len(rows) and (int(rows.min()) < 0 or int(rows.max()) >= n):
            raise ValueError(f"neighbour ids must lie in [0, {n})")
        shards.append(_shard_table(rows, seg_ptr, lo, hi, device))
    buffered = planner.eng.buffered
    return ShardedStructure(
        graph=planner.eng.graph,
        version=buffered.version if buffered is not None else 0,
        n=n,
        E=int(seg_ptr[-1]),
        S=S,
        V=int(lay["owned_ids"].shape[1]),
        seg_ptr=seg_ptr,
        bounds=bounds,
        owned_ids_h=lay["owned_ids"],
        owned_mask_h=lay["owned_mask"],
        pad_edges=int(lay["pad_edges"]),
        per_shard_edges=lay["per_shard_edges"],
        devices=[torch.device(device)],
        shards=shards,
    )


def shard_chunk(backend, ss, algorithm: str, steps: int, core, cnt, active,
                nact, cand=None) -> tuple:
    """``steps`` supersteps of the shard backend from ``(core, cnt, active,
    nact)`` (:meth:`ShardedBackend.superstep`'s layout), gated on the
    frontier: a superstep whose frontier is empty changes nothing.
    Returns ``(core, cnt, active, nact, fronts, upds, ran)``: the state
    after the chunk, each superstep's frontier (one mask a shard), its
    updates and whether it had work (0-dim tensors, no host sync)."""
    fronts, upds, ran = [], [], []
    for _ in range(steps):
        fronts.append(active)
        ran.append(nact > 0)
        core, cnt, active, upd, nact = backend.superstep(
            ss, core, cnt, active, algorithm=algorithm, cand=cand)
        upds.append(upd)
    return core, cnt, active, nact, fronts, upds, ran


def build_shard_chunk_fn(mesh, algorithm: str, n: int, num_probes: int,
                         chunk: int | None = None):
    """The chunked superstep of the shard backend over ``mesh`` (the
    reference's ``build_shard_chunk_fn``): a function ``fn(ss, core, cnt,
    active, nact)`` running :func:`shard_chunk` for ``chunk`` supersteps
    (``chunk_len``) of ``algorithm``, on one shard a rank of the mesh's
    process group over all its axes, or on the mesh's devices in one
    process.  ``fn.backend`` binds a graph (``fn.backend.bind_resident(
    planner)`` gives ``ss``).  ``n`` and ``num_probes`` are kept only so
    that the signature is the reference's (they size its jit); nothing
    here reads them.  A mesh with no
    devices (a production mesh of the dry run) gives a function that
    refuses to run."""
    from .engine import ShardedBackend

    if algorithm not in ("semicore+", "semicore*"):
        raise ValueError(f"the chunk function runs a frontier algorithm "
                         f"(semicore+ or semicore*), not {algorithm!r}")
    steps = chunk_len(chunk)
    if mesh.device_mesh is not None:
        backend = ShardedBackend(group=mesh.get_group(mesh.axis_names),
                                 device=mesh.device)
    elif mesh.devices:
        backend = ShardedBackend(devices=mesh.devices)
    else:
        backend = None

    def fn(ss, core, cnt, active, nact):
        if backend is None:
            raise RuntimeError("this mesh has no devices (a layout for the "
                               "dry run); make it with make_host_mesh")
        return shard_chunk(backend, ss, algorithm, steps, core, cnt, active,
                           nact)

    fn.backend = backend
    return fn


def run_sharded(engine, algorithm: str, backend, *,
                core: np.ndarray | None = None,
                cnt: np.ndarray | None = None,
                initial_cnt_scan: bool = False,
                superstep_chunk: int | None = None,
                max_supersteps: int | None = None,
                settle_mask: np.ndarray | None = None) -> DecompResult:
    """Run a batch-schedule decomposition with the edge table sharded.

    The shard-layout sibling of :func:`run_resident`: identical passes,
    histories and planner replay, with cnt and the frontier kept
    owner-local (one (n,) array a shard, only its owned rows meaningful)
    and the core replicated per device.  Each superstep is the backend's
    :meth:`~repro_torch.core.engine.ShardedBackend.superstep`.  Updates
    are counted on the gathered core, as the reference's shard does: an
    edgeless row that drops counts.  ``max_supersteps`` budgets the run
    exactly (the last chunk is cut to the remaining budget); the partial
    core is a valid upper bound by monotone convergence.
    """
    if settle_mask is not None and algorithm != "semicore*":
        raise ValueError("settle_mask is a semicore* (cnt-gated) discipline")
    if algorithm not in ("semicore", "semicore+", "semicore*"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    planner = engine.planner
    n = engine.n
    ss = backend.bind_resident(planner)
    chunk = chunk_len(superstep_chunk)
    om = _pass_obs(algorithm, backend.name)
    d0 = ss.devices[0] if ss.devices else None  # none: no node, no edge

    warm = core is not None
    if warm:
        core = np.asarray(core, dtype=np.int64).copy()
    else:
        core = engine.degrees().astype(np.int64)

    upd_hist: list = []
    comp_hist: list = []
    iters = 0
    comp = 0
    all_nodes = np.arange(n, dtype=np.int64)

    def replicate(arr) -> dict:
        host = torch.as_tensor(np.asarray(arr, dtype=np.int32))
        return {d: host.to(d, copy=True) for d in ss.devices}

    def localize(arr, dtype) -> list:
        """A global (n,) host array as one (n,) array a shard, zero (False)
        outside the shard's owned range."""
        host = torch.as_tensor(np.asarray(arr).astype(dtype))
        out = []
        for t in ss.shards:
            x = torch.zeros(n, dtype=host.dtype, device=t.device)
            x[t.lo:t.hi] = host[t.lo:t.hi].to(t.device)
            out.append(x)
        return out

    def globalize(parts) -> np.ndarray:
        """The owned slices of per-shard (n,) arrays as one host array."""
        return backend.owned_host(
            ss, [x[t.lo:t.hi] for t, x in zip(ss.shards, parts)], np.int64)

    def chunk_size() -> int:
        if max_supersteps is None:
            return chunk
        return max(1, min(chunk, max_supersteps - iters))

    def budget_hit() -> bool:
        return max_supersteps is not None and iters >= max_supersteps

    def pull(fronts, upds, ran, done):
        """One chunk's summaries to the host: (frontier masks or None,
        updates, ran flags, done); the masks from the owned slices."""
        _HOST_SYNCS.inc()
        summary = torch.stack(
            [*upds, *(r.to(torch.int32) for r in ran),
             done.to(torch.int32)]).cpu().numpy()
        k = len(upds)
        masks = None
        if fronts:
            masks = backend.owned_host(
                ss, [torch.stack([f[i][t.lo:t.hi] for f in fronts])
                     for i, t in enumerate(ss.shards)], bool, (k,))
        return masks, summary[:k], summary[k:2 * k].astype(bool), \
            bool(summary[-1])

    def result(core_f, cnt_f):
        backend.unbind()
        return DecompResult(
            core=_host(core_f[d0] if isinstance(core_f, dict) else core_f),
            cnt=None if cnt_f is None else _host(cnt_f),
            iterations=iters,
            node_computations=comp,
            edge_block_reads=planner.reader.reads,
            node_table_reads=planner.reader.node_table_reads,
            algorithm=algorithm,
            schedule="batch",
            updates_per_iter=upd_hist,
            computations_per_iter=comp_hist,
            backend=backend.name,
            num_shards=ss.S,
            shard_pad_edges=ss.pad_edges,
        )

    def replay_all_nodes(upd: int) -> None:
        nonlocal iters, comp
        iters += 1
        comp += n
        upd_hist.append(upd)
        comp_hist.append(n)
        planner.charge_only(all_nodes)
        planner.account_node_scan(0, n - 1)
        om[0].inc()
        om[1].inc(n)
        om[2].inc(upd)

    def frontier_loop(algo, core_t, cnt_t, active_t, cand_t):
        """The chunked loop of semicore* / semicore+ from the owned
        frontier ``active_t``; returns the final (core, cnt)."""
        nonlocal iters, comp
        nact = backend.count_active(ss, active_t)
        while True:
            with _trace.span("resident.chunk", cat="engine", algorithm=algo,
                             backend=backend.name, shards=ss.S,
                             chunk=chunk) as sp:
                core_t, cnt_t, active_t, nact, fronts, upds, ran = \
                    shard_chunk(backend, ss, algo, chunk_size(), core_t,
                                cnt_t, active_t, nact, cand_t)
                masks, upds_h, ran_h, done = pull(fronts, upds, ran,
                                                  nact == 0)
                iters, comp = _replay_chunk(
                    planner, ss, 0, 0, None, masks, upds_h, ran_h, upd_hist,
                    comp_hist, iters, comp, om, algo)
                if sp.active:
                    sp.set(passes_run=int(ran_h.sum()))
            if done or budget_hit():
                return core_t, cnt_t

    # ------------------------------------------------------------ semicore*
    if algorithm == "semicore*":
        core_t = replicate(core) if ss.E else None
        if initial_cnt_scan:
            # warm_settle prologue: one accounted full scan recomputes cnt
            # exactly (Eq. 2) w.r.t. the warm upper bound, on every shard
            t0 = time.perf_counter()
            with _trace.span("cnt_prologue", cat="maintenance",
                             backend=backend.name, nodes=n):
                planner.charge_only(all_nodes)
                planner.account_node_scan(0, n - 1)
                if ss.E:
                    cnt = globalize(backend.counts(ss, core_t))
                else:
                    cnt = np.zeros(n, dtype=np.int64)
            _MAINT_PROLOGUE.observe(time.perf_counter() - t0)
        elif warm:
            cnt = np.asarray(cnt, dtype=np.int64).copy()
        else:
            cnt = np.zeros(n, dtype=np.int64)
        active0 = (cnt < core) & (core > 0)
        if settle_mask is not None:
            active0 &= np.asarray(settle_mask, dtype=bool)
        if ss.E == 0:
            # edgeless table: any deficient node drops straight to h = 0 in
            # one pass, and nothing can re-activate — numpy's loop verbatim
            if active0.any():
                f = np.flatnonzero(active0)
                iters, comp = 1, len(f)
                upd = int((core[f] != 0).sum())
                upd_hist.append(upd)
                comp_hist.append(len(f))
                _replay_pass(planner, f, None, ss, 0, 0)
                om[0].inc()
                om[1].inc(len(f))
                om[2].inc(upd)
                core[f] = 0
                cnt[f] = 0
            return result(core, cnt)
        if not active0.any():
            # settled warm state: zero passes, like numpy's while-loop
            return result(core, cnt)
        cand_t = None if settle_mask is None else localize(
            np.asarray(settle_mask, dtype=bool), bool)
        core_t, cnt_t = frontier_loop(
            "semicore*", core_t, localize(cnt, np.int32),
            localize(active0, bool), cand_t)
        return result(core_t, globalize(cnt_t))

    # ------------------------------------------------- semicore / semicore+
    if ss.E == 0:
        # h == core == degrees == 0 everywhere: one all-node pass converges
        # (semicore runs it even on an empty graph, as numpy's loop does)
        if algorithm == "semicore" or n:
            replay_all_nodes(0)
        return result(core, None)

    core_t = replicate(core)
    if algorithm == "semicore+":
        core_t, _ = frontier_loop("semicore+", core_t, None,
                                  localize(np.ones(n, dtype=bool), bool),
                                  None)
        return result(core_t, None)

    # semicore: every node, every pass — the final no-update pass included;
    # once done, the pass sees no row active and changes nothing
    done_t = torch.zeros((), dtype=torch.bool, device=d0)
    while True:
        with _trace.span("resident.chunk", cat="engine",
                         algorithm="semicore", backend=backend.name,
                         shards=ss.S, chunk=chunk) as sp:
            upds, ran = [], []
            for _ in range(chunk_size()):
                running = ~done_t
                ran.append(running)
                active_t = [t.owned & running.to(t.device)
                            for t in ss.shards]
                core_t, _, _, upd, _ = backend.superstep(
                    ss, core_t, None, active_t, algorithm="semicore")
                done_t = upd == 0
                upds.append(upd)
            _, upds_h, ran_h, done = pull([], upds, ran, done_t)
            for k in range(len(ran_h)):
                if not ran_h[k]:
                    break
                replay_all_nodes(int(upds_h[k]))
                _trace.instant("superstep.replay", cat="engine",
                               algorithm="semicore", index=iters,
                               frontier=n, updates=int(upds_h[k]))
            if sp.active:
                sp.set(passes_run=int(ran_h.sum()))
        if done or budget_hit():
            break
    return result(core_t, None)
