"""I/O-efficient core maintenance (paper §V): SemiDelete* (Alg. 6),
SemiInsert (Alg. 7), SemiInsert* (Alg. 8).

The port's counterpart of ``repro/core/maintenance.py``.  The paper's
per-edge algorithms run in numpy on the host, as the reference runs them;
a micro-batch on a device backend settles on the card, through the
grouped masked settle (``parallel_maint``, the default) or one
``warm_settle``.

All three run over the same blocked storage + edge-update memory buffer
(§V.A *Graph Maintenance*) and keep the decomposition state (core, cnt)
exact after every operation, so maintenance ops chain indefinitely.

Algorithm 8 bookkeeping note (the pseudocode is ambiguous between two
readings of its lines 11-12 / 22-25; it is resolved against the exact cnt
trace of Example 5.3):  a ○-status node's cnt follows the *predictive*
Eq. 4 (cnt*) — it already counts every still-promising core==c_old
candidate, so a neighbor's ?→○ promotion must NOT increment it (only
Eq.2-maintained nodes, i.e. core==c_old+1 originals, get +1), and a
neighbor's ○→✕ flip decrements Eq.2-maintained nodes via the
core==c_old+1 loop and ○ nodes via the status==○ loop, once each.  With
this reading the final cnt values are exactly Eq. 2 w.r.t. the new cores
(verified by tests against recomputation-from-scratch).

Spans (``obs.trace``) split a batch's wall: ``maintenance.structural``
(the ops into the buffer and their cnt deltas), ``maintenance.plan``
(the flat adjacency snapshot, planning and the peel),
``maintenance.settle`` (the device fixpoint, the structure's rebuild and
upload ``resident.structure`` inside it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .. import runtime as _runtime
from ..graph.storage import DEFAULT_BLOCK_EDGES
from ..graph.updates import BufferedGraph
from ..obs import metrics as _metrics, trace as _trace
from .engine import ComputeBackend, resolve_backend, warm_settle
from .semicore import HostEngine
from .update import Delete, UpdateBatch

__all__ = ["MaintStats", "BatchMaintStats", "CoreMaintainer"]

# apply settle latency, labeled by path: "per-edge" is the paper's seq
# maintenance (Algs. 6-8), "batch-settle" the warm_settle discipline of the
# device backends, "parallel" the grouped settle (the exact-cnt prologue
# cost is the separate repro_maintenance_cnt_prologue_seconds histogram in
# engine.py)
_SETTLE_SECONDS = _metrics.histogram(
    "repro_maintenance_settle_seconds",
    "apply settle latency per micro-batch",
)
_BATCHES = _metrics.counter(
    "repro_maintenance_batches_total",
    "Micro-batches applied by CoreMaintainer.apply",
)
_UPDATES_APPLIED = _metrics.counter(
    "repro_maintenance_updates_applied_total",
    "Structural edge updates applied (deletes + inserts, no-ops excluded)",
)

_PHI, _Q, _CIRC, _CROSS = 0, 1, 2, 3


@dataclass
class MaintStats:
    """Maintenance result — per-edge ops and micro-batches alike.

    The positional prefix (algorithm .. num_changed) is the per-edge
    result; the ``num_*`` trio counts a batch's ops; the ``groups`` /
    ``largest_group`` / ``fallbacks`` / ``settle_passes`` tail is the
    parallel grouped settle and stays zero on every serial path.
    """

    algorithm: str
    node_computations: int = 0
    edge_block_reads: int = 0
    node_table_reads: int = 0
    iterations: int = 0
    num_changed: int = 0  # nodes whose core differs from the op-start core
    num_deletes: int = 0
    num_inserts: int = 0
    num_noops: int = 0  # updates already reflected in the graph (skipped)
    groups: int = 0  # independent groups planned by the parallel settle
    largest_group: int = 0  # candidate-node count of the largest group
    fallbacks: int = 0  # ineligible groups + feasibility escalations
    settle_passes: int = 0  # fixpoint passes of the grouped settle


#: the reference's name for the micro-batch result (the same type)
BatchMaintStats = MaintStats


class CoreMaintainer:
    """Holds (core, cnt) over a BufferedGraph; applies edge updates.

    ``backend`` ("cuda" | "torch" | "numpy" | a ComputeBackend instance;
    ``None`` resolves ``REPRO_TORCH_BACKEND``, default "cuda") picks the
    settle substrate and ``device`` places a named device backend: ``None``
    is the first GPU and raises without one, ``device="cpu"`` runs the
    kernels' plain versions on the host.  ``settings`` (a
    :class:`repro_torch.runtime.Settings`) supplies the backend, the
    resident chunk and ``parallel_maint`` where the arguments leave them
    unset.  On "numpy" the serial path is the paper's per-edge seq
    maintenance (Algs. 6-8); on a device backend it is one warm-started
    SemiCore* batch settle.  Device backends settle on their bound resident
    structure, which is version-keyed: a no-op batch re-uploads nothing.
    ``retry`` (a :class:`repro_torch.faults.RetryPolicy`) retries a failed
    block fill of the engine's reader.
    """

    def __init__(
        self,
        graph,
        block_edges: int = DEFAULT_BLOCK_EDGES,
        state: tuple[np.ndarray, np.ndarray] | None = None,
        pool_blocks: int = 1,
        backend=None,
        superstep_chunk: int | None = None,
        settings: "_runtime.Settings | None" = None,
        group_cap: int | None = None,
        device=None,
        retry=None,
    ):
        if settings is not None:
            if backend is None:
                backend = settings.backend
            if superstep_chunk is None:
                superstep_chunk = settings.resident_chunk
        self._parallel_default = (
            None if settings is None else settings.parallel_maint)
        self.settings = settings
        self.group_cap = group_cap
        self.bg = graph if isinstance(graph, BufferedGraph) else BufferedGraph(graph)
        self.engine = HostEngine(
            self.bg, block_edges, pool_blocks=pool_blocks, settings=settings,
            retry=retry)
        self.backend = resolve_backend(backend, device)
        self.superstep_chunk = superstep_chunk
        if self.backend.device_resident and not isinstance(
                backend, ComputeBackend):
            # long-lived owner of a backend it created itself: keep the
            # device-resident edge table cached across apply calls — it is
            # version-keyed, so a batch that changed structure rebuilds it
            # and a no-op batch re-uploads nothing.  A caller-supplied
            # instance is left untouched: its one-shot unbind-drops-
            # everything guarantee stays the caller's to manage.
            self.backend.retain_structure = True
        if state is None:
            if self.backend.name == "numpy":
                r = self.engine.semicore_star("seq", backend="numpy")
            else:
                r = self.engine.semicore_star(
                    "batch", backend=self.backend,
                    superstep_chunk=superstep_chunk)
            self.core, self.cnt = r.core, r.cnt
        else:
            self.core = np.asarray(state[0], dtype=np.int64).copy()
            self.cnt = np.asarray(state[1], dtype=np.int64).copy()

    # ------------------------------------------------------------------ utils
    def _io_snapshot(self):
        return (self.engine.reader.reads, self.engine.reader.node_table_reads)

    def _io_delta(self, snap):
        return (
            self.engine.reader.reads - snap[0],
            self.engine.reader.node_table_reads - snap[1],
        )

    # =====================================================================
    # The update surface (paper §V)
    # =====================================================================
    def apply(
        self,
        batch: UpdateBatch,
        insert_algorithm: str = "semiinsert*",
    ) -> MaintStats:
        """Apply one micro-batch of typed, order-preserving updates.

        ``batch`` is an :class:`UpdateBatch` of :class:`Insert` /
        :class:`Delete` ops (any iterable of ops is promoted).  Updates
        already reflected in the graph (deleting a missing edge, inserting
        a present one) count as no-ops.

        Dispatch: the parallel independent-group settle unless
        ``REPRO_TORCH_PARALLEL_MAINT=0`` / ``Settings.parallel_maint``
        disables it, in which case the serial oracle runs — the paper's
        per-edge seq maintenance (Algs. 6-8) on numpy, one warm-started
        SemiCore* batch settle on device backends.  Every path lands on the
        same exact (core, cnt) fixpoint.
        """
        if not isinstance(batch, UpdateBatch):
            batch = UpdateBatch(tuple(batch))
        if _runtime.setting("parallel_maint", self._parallel_default):
            return self._apply_parallel(batch, insert_algorithm)
        if self.backend.name != "numpy":
            return self._apply_batch_settled(batch.deletes, batch.inserts)
        return self._apply_per_edge(batch, insert_algorithm)

    def _apply_per_edge(self, batch: UpdateBatch,
                        insert_algorithm: str) -> MaintStats:
        """The paper's serial per-edge maintenance, in op order."""
        snap = self._io_snapshot()
        core0 = self.core.copy()
        comp = iters = nd = ni = noop = 0
        t0 = time.perf_counter()
        with _trace.span("maintenance.apply_batch", cat="maintenance",
                         path="per-edge", deletes=len(batch.deletes),
                         inserts=len(batch.inserts)) as sp:
            for op in batch:
                try:
                    if isinstance(op, Delete):
                        s = self._delete_edge(int(op.u), int(op.v))
                        nd += 1
                    else:
                        s = self._insert_edge(int(op.u), int(op.v),
                                              algorithm=insert_algorithm)
                        ni += 1
                except KeyError:
                    noop += 1
                    continue
                comp += s.node_computations
                iters += s.iterations
            if sp.active:
                sp.set(applied=nd + ni, noops=noop)
        _SETTLE_SECONDS.labels(path="per-edge").observe(
            time.perf_counter() - t0)
        _BATCHES.labels(path="per-edge").inc()
        _UPDATES_APPLIED.labels(path="per-edge").inc(nd + ni)
        io = self._io_delta(snap)
        return MaintStats(
            algorithm=f"batch({insert_algorithm})",
            num_deletes=nd,
            num_inserts=ni,
            num_noops=noop,
            node_computations=comp,
            edge_block_reads=io[0],
            node_table_reads=io[1],
            iterations=iters,
            num_changed=int((self.core != core0).sum()),
        )

    def _apply_parallel(self, batch: UpdateBatch,
                        insert_algorithm: str) -> MaintStats:
        """Parallel independent-group settle.

        Structural phase first: every op lands in the buffered graph and
        its Eq. 2 delta lands in cnt — all w.r.t. the *pre-batch* cores, so
        after the loop cnt is exactly Eq. 2 (core0, post-batch graph).
        :func:`parallel_maint.grouped_settle` then plans per-update
        candidate sets, partitions them into independent groups and settles
        the whole batch in saturation rounds — host-side peel of each
        level's exact rise set, then one group-masked device fixpoint per
        round, re-rooted at capped risers until exact.  Oversized candidate
        sets and a failed cnt>=core certificate escalate to the serial warm
        settle, so every path lands on the same fixpoint.
        """
        from .parallel_maint import DEFAULT_GROUP_CAP, grouped_settle

        snap = self._io_snapshot()
        core0 = self.core
        cnt = self.cnt
        nd = ni = noop = 0
        applied: list = []
        t0 = time.perf_counter()
        with _trace.span("maintenance.parallel_settle", cat="maintenance",
                         path="parallel", backend=self.backend.name,
                         deletes=len(batch.deletes),
                         inserts=len(batch.inserts)) as sp:
            with _trace.span("maintenance.structural", cat="maintenance"):
                for op in batch:
                    u, v = int(op.u), int(op.v)
                    if isinstance(op, Delete):
                        if not self.bg.delete_edge(u, v):
                            noop += 1
                            continue
                        nd += 1
                        if core0[u] <= core0[v]:
                            cnt[u] -= 1
                        if core0[v] <= core0[u]:
                            cnt[v] -= 1
                        applied.append(("-", u, v))
                    else:
                        if not self.bg.insert_edge(u, v):
                            noop += 1
                            continue
                        ni += 1
                        if core0[u] <= core0[v]:
                            cnt[u] += 1
                        if core0[v] <= core0[u]:
                            cnt[v] += 1
                        applied.append(("+", u, v))
            changed = 0
            groups = largest = fallbacks = passes = comp = 0
            if applied:
                cap = (DEFAULT_GROUP_CAP if self.group_cap is None
                       else self.group_cap)
                core_f, cnt_f, plan, info = grouped_settle(
                    self, applied, cap)
                changed = int((core_f != core0).sum())
                groups = len(plan.groups)
                largest = plan.largest_group
                fallbacks = info["fallbacks"]
                passes = info["iterations"]
                comp = info["node_computations"]
            if sp.active:
                sp.set(applied=nd + ni, noops=noop, groups=groups,
                       fallbacks=fallbacks, iterations=passes)
        _SETTLE_SECONDS.labels(path="parallel").observe(
            time.perf_counter() - t0)
        _BATCHES.labels(path="parallel").inc()
        _UPDATES_APPLIED.labels(path="parallel").inc(nd + ni)
        io = self._io_delta(snap)
        return MaintStats(
            algorithm=f"parallel({self.backend.name})",
            num_deletes=nd,
            num_inserts=ni,
            num_noops=noop,
            node_computations=comp,
            edge_block_reads=io[0],
            node_table_reads=io[1],
            iterations=passes,
            num_changed=changed,
            groups=groups,
            largest_group=largest,
            fallbacks=fallbacks,
            settle_passes=passes,
        )

    def _apply_batch_settled(self, deletes, inserts) -> BatchMaintStats:
        """Batched maintenance on a compute backend: structural updates
        first, then one :func:`engine.warm_settle` — the warm upper bound +
        exact-cnt prologue + SemiCore* batch discipline."""
        snap = self._io_snapshot()
        core0 = self.core.copy()
        nd = ni = noop = 0
        t0 = time.perf_counter()
        with _trace.span("maintenance.batch_settle", cat="maintenance",
                         path="batch-settle", backend=self.backend.name,
                         deletes=len(deletes), inserts=len(inserts)) as sp:
            with _trace.span("maintenance.structural", cat="maintenance"):
                for u, v in deletes:
                    if self.bg.delete_edge(int(u), int(v)):
                        nd += 1
                    else:
                        noop += 1
                for u, v in inserts:
                    if self.bg.insert_edge(int(u), int(v)):
                        ni += 1
                    else:
                        noop += 1
            comp = iters = 0
            if nd or ni:
                with _trace.span("maintenance.settle", cat="maintenance"):
                    r = warm_settle(self.engine, self.core, ni, self.backend,
                                    superstep_chunk=self.superstep_chunk)
                self.core, self.cnt = r.core, r.cnt
                comp, iters = r.node_computations, r.iterations
            if sp.active:
                sp.set(applied=nd + ni, noops=noop, iterations=iters)
        _SETTLE_SECONDS.labels(path="batch-settle").observe(
            time.perf_counter() - t0)
        _BATCHES.labels(path="batch-settle").inc()
        _UPDATES_APPLIED.labels(path="batch-settle").inc(nd + ni)
        io = self._io_delta(snap)
        return BatchMaintStats(
            algorithm=f"batch-settle({self.backend.name})",
            num_deletes=nd,
            num_inserts=ni,
            num_noops=noop,
            node_computations=comp,
            edge_block_reads=io[0],
            node_table_reads=io[1],
            iterations=iters,
            num_changed=int((self.core != core0).sum()),
        )

    # =====================================================================
    # Algorithm 6: SemiDelete*
    # =====================================================================
    def _delete_edge(self, u: int, v: int) -> MaintStats:
        if not self.bg.delete_edge(u, v):
            raise KeyError(f"edge ({u}, {v}) does not exist")
        snap = self._io_snapshot()
        old_core = self.core.copy()
        cu, cv = int(self.core[u]), int(self.core[v])
        if cu < cv:
            self.cnt[u] -= 1
            rng = (u, u)
        elif cv < cu:
            self.cnt[v] -= 1
            rng = (v, v)
        else:
            self.cnt[u] -= 1
            self.cnt[v] -= 1
            rng = (min(u, v), max(u, v))
        r = self.engine.semicore_star(
            "seq", core=self.core, cnt=self.cnt, vrange=rng, backend="numpy"
        )
        self.core, self.cnt = r.core, r.cnt
        io = self._io_delta(snap)
        return MaintStats(
            "semidelete*",
            r.node_computations,
            io[0],
            io[1],
            r.iterations,
            int((self.core != old_core).sum()),
            num_deletes=1,
        )

    # =====================================================================
    # Algorithm 7: SemiInsert (two-phase)
    # =====================================================================
    def _insert_edge(self, u: int, v: int,
                     algorithm: str = "semiinsert*") -> MaintStats:
        if algorithm == "semiinsert*":
            return self._insert_star(u, v)
        return self._insert_two_phase(u, v)

    def _insert_common(self, u: int, v: int):
        """Alg. 7 lines 1-5 (shared with Alg. 8)."""
        if not self.bg.insert_edge(u, v):
            raise KeyError(f"edge ({u}, {v}) already exists")
        if self.core[u] > self.core[v]:
            u, v = v, u
        self.cnt[u] += 1
        if self.core[v] == self.core[u]:
            self.cnt[v] += 1
        return u, v, int(self.core[u])

    def _insert_two_phase(self, u0: int, v0: int) -> MaintStats:
        snap = self._io_snapshot()
        old_core = self.core.copy()
        core, cnt, eng = self.core, self.cnt, self.engine
        n = eng.n
        u, v, c_old = self._insert_common(u0, v0)

        # --- phase 1: grow + optimistically promote the candidate set -------
        active = np.zeros(n, dtype=bool)
        active[u] = True
        vmin = vmax = u
        comp = 0
        iters = 0
        update = True
        while update:
            update = False
            iters += 1
            nvmin, nvmax = n - 1, 0
            scan_lo = vmin
            w = vmin
            while w <= vmax:
                if active[w] and core[w] == c_old:
                    core[w] = c_old + 1
                    nbrs = eng.nbrs(w)
                    comp += 1
                    ncores = core[nbrs]
                    cnt[w] = int((ncores >= c_old + 1).sum())
                    bumped = nbrs[ncores == c_old + 1]  # lines 15-16 (Eq. 2)
                    if len(bumped):
                        np.add.at(cnt, bumped, 1)
                    for x in nbrs[ncores == c_old]:  # lines 17-20
                        x = int(x)
                        if not active[x]:
                            active[x] = True
                            if x > vmax:
                                vmax = x
                            if x < w:
                                update = True
                                nvmin = min(nvmin, x)
                                nvmax = max(nvmax, x)
                w += 1
            eng.reader.account_node_table_scan(scan_lo, vmax)
            vmin, vmax = nvmin, nvmax

        # --- phase 2: settle with Algorithm 5 (lines 22-25) -----------------
        act = np.flatnonzero(active)
        rng = (min(int(act.min()), u), max(int(act.max()), u))
        r = eng.semicore_star("seq", core=core, cnt=cnt, vrange=rng,
                              backend="numpy")
        self.core, self.cnt = r.core, r.cnt
        io = self._io_delta(snap)
        return MaintStats(
            "semiinsert",
            comp + r.node_computations,
            io[0],
            io[1],
            iters + r.iterations,
            int((self.core != old_core).sum()),
            num_inserts=1,
        )

    # =====================================================================
    # Algorithm 8: SemiInsert* (one-phase status machine)
    # =====================================================================
    def _insert_star(self, u0: int, v0: int) -> MaintStats:
        snap = self._io_snapshot()
        old_core = self.core.copy()
        core, cnt, eng = self.core, self.cnt, self.engine
        n = eng.n
        u, v, c_old = self._insert_common(u0, v0)

        status = np.full(n, _PHI, dtype=np.uint8)
        status[u] = _Q
        vmin = vmax = u
        comp = 0
        iters = 0
        update = True
        while update:
            update = False
            iters += 1
            nvmin, nvmax = n - 1, 0
            scan_lo = vmin
            w = vmin
            while w <= vmax:
                nbrs = None
                if status[w] == _Q:
                    nbrs = eng.nbrs(w)
                    comp += 1
                    # ComputeCnt* (Eq. 4; lines 29-33)
                    ncores = core[nbrs]
                    nst = status[nbrs]
                    cnt[w] = int(
                        (
                            (ncores > c_old)
                            | (
                                (ncores == c_old)
                                & (cnt[nbrs] >= c_old + 1)
                                & (nst != _CROSS)
                            )
                        ).sum()
                    )
                    status[w] = _CIRC
                    core[w] = c_old + 1
                    # lines 11-12: Eq.2-maintained peers gain w
                    bumped = nbrs[(ncores == c_old + 1) & (nst != _CIRC)]
                    if len(bumped):
                        np.add.at(cnt, bumped, 1)
                    if cnt[w] >= c_old + 1:  # lines 13-17: expand
                        cand = nbrs[
                            (ncores == c_old)
                            & (cnt[nbrs] >= c_old + 1)
                            & (nst == _PHI)
                        ]
                        for x in cand:
                            x = int(x)
                            status[x] = _Q
                            if x > vmax:
                                vmax = x
                            if x < w:
                                update = True
                                nvmin = min(nvmin, x)
                                nvmax = max(nvmax, x)
                if status[w] == _CIRC and cnt[w] < c_old + 1:  # lines 18-27
                    if nbrs is None:
                        nbrs = eng.nbrs(w)
                        comp += 1
                    ncores = core[nbrs]
                    cnt[w] = int((ncores >= c_old).sum())  # ComputeCnt(nbr, c_old)
                    status[w] = _CROSS
                    core[w] = c_old
                    nst = status[nbrs]
                    # lines 22-23: Eq.2-maintained peers lose w ...
                    dec = nbrs[(ncores == c_old + 1) & (nst != _CIRC)]
                    if len(dec):
                        np.subtract.at(cnt, dec, 1)
                    # lines 24-27: ... and ○ nodes lose a promising candidate
                    circ = nbrs[nst == _CIRC]
                    for x in circ:
                        x = int(x)
                        cnt[x] -= 1
                        if cnt[x] < c_old + 1:
                            if x > vmax:
                                vmax = x
                            if x < w:
                                update = True
                                nvmin = min(nvmin, x)
                                nvmax = max(nvmax, x)
                w += 1
            eng.reader.account_node_table_scan(scan_lo, vmax)
            vmin, vmax = nvmin, nvmax

        io = self._io_delta(snap)
        return MaintStats(
            "semiinsert*",
            comp,
            io[0],
            io[1],
            iters,
            int((self.core != old_core).sum()),
            num_inserts=1,
        )
