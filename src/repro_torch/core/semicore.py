"""Semi-external core decomposition: SemiCore (Alg. 3), SemiCore+ (Alg. 4),
SemiCore* (Alg. 5) over blocked, I/O-accounted storage.

The port's counterpart of ``repro/core/semicore.py``.  Two schedules:

* ``schedule="seq"``  — the paper's exact pseudocode (Gauss–Seidel, with
  in-pass forward triggering via UpdateRange), on the numpy host path: the
  reference every other configuration is checked against.
* ``schedule="batch"`` — all due nodes of a pass recomputed at once from
  the pass-start state (Jacobi), through :mod:`repro_torch.core.engine`;
  ``backend="cuda"`` (the default) runs the fixpoint device-resident on the
  hand-written kernels (the fused superstep, or with
  ``CudaBackend(fused=False)`` the per-probe segment sums),
  ``backend="torch"`` on plain torch ops.

Both schedules account I/O identically: one read I/O per distinct
edge-table block touched per pass, plus node-table blocks for the scanned
[v_min, v_max] range.
"""
from __future__ import annotations

import os

import numpy as np

from .. import runtime as _runtime
from ..graph.storage import BlockReader, DEFAULT_BLOCK_EDGES
from ..graph.updates import BufferedGraph
from ..obs import trace as _trace
from .engine import DecompResult, PassPlanner, _pass_obs, run_batch
from .localcore import local_core

__all__ = ["DecompResult", "HostEngine", "decompose"]


def _seq_only(backend) -> None:
    """The seq schedule runs on the numpy host only: a non-numpy backend
    asked for explicitly or through ``REPRO_TORCH_BACKEND`` raises rather
    than silently running numpy."""
    if backend is None:
        backend = os.environ.get(_runtime.ENV_VARS["backend"])
    if backend is not None and str(getattr(backend, "name", backend)) != "numpy":
        raise ValueError(
            "schedule='seq' is the paper-faithful reference path and runs on "
            "the numpy host backend only; use schedule='batch' for "
            f"backend={backend!r}")


class HostEngine:
    """Host-side semi-external engine over blocked storage (+ update buffer).

    ``pool_blocks`` sizes the :class:`BlockReader` LRU pool (1 is the
    paper's single buffer).  Batch-schedule compute goes to
    :mod:`repro_torch.core.engine`: ``backend=`` ("cuda" | "torch" |
    "numpy" | a ComputeBackend instance) and ``device=`` pick the
    substrate.  ``settings`` (a :class:`repro_torch.runtime.Settings`)
    supplies the backend and the resident chunk where a batch call leaves
    them ``None`` (the environment still wins).  ``retry`` (a
    :class:`repro_torch.faults.RetryPolicy`) retries a failed block fill.
    """

    def __init__(self, graph, block_edges: int = DEFAULT_BLOCK_EDGES,
                 pool_blocks: int = 1, retry=None,
                 settings: "_runtime.Settings | None" = None):
        self.settings = settings
        if isinstance(graph, BufferedGraph):
            self.buffered: BufferedGraph | None = graph
            base = graph.base
        else:
            self.buffered = None
            base = graph
        self.graph = base
        self.reader = BlockReader(base, block_edges, pool_blocks=pool_blocks,
                                  retry=retry)
        self.planner = PassPlanner(self)

    def _sync(self) -> None:
        """Re-point at the current base CSR after a buffer flush rewrite."""
        if self.buffered is not None and self.buffered.base is not self.graph:
            self.graph = self.buffered.base
            self.reader.graph = self.graph
            self.reader.invalidate()  # resident blocks belong to the old CSR

    def nbrs(self, v: int) -> np.ndarray:
        self._sync()
        raw = self.reader.load_neighbors(v)
        if self.buffered is not None:
            return self.buffered.merged_neighbors(v, raw)
        return raw

    def degrees(self) -> np.ndarray:
        if self.buffered is not None:
            return self.buffered.degrees()
        return self.graph.degrees()

    @property
    def n(self) -> int:
        return self.graph.n

    def _defaults(self, backend, superstep_chunk):
        """Fill unset per-call knobs from this engine's Settings."""
        if self.settings is not None:
            if backend is None:
                backend = _runtime.setting("backend", self.settings.backend)
            if superstep_chunk is None:
                superstep_chunk = _runtime.setting(
                    "resident_chunk", self.settings.resident_chunk)
        return backend, superstep_chunk

    # =====================================================================
    # Algorithm 3: SemiCore
    # =====================================================================
    def semicore(self, schedule: str = "seq", backend=None,
                 superstep_chunk: int | None = None,
                 device=None) -> DecompResult:
        if schedule == "batch":
            backend, superstep_chunk = self._defaults(backend, superstep_chunk)
            return run_batch(self, "semicore", backend,
                             superstep_chunk=superstep_chunk, device=device)
        _seq_only(backend)
        n = self.n
        core = self.degrees().astype(np.int64)
        comp = 0
        iters = 0
        upd_hist, comp_hist = [], []
        update = True
        om = _pass_obs("semicore", "numpy", "seq")
        while update:
            update = False
            iters += 1
            upd = 0
            with _trace.span("superstep", cat="engine", algorithm="semicore",
                             backend="numpy", schedule="seq",
                             index=iters) as sp:
                self.reader.account_node_table_scan(0, n - 1)
                for v in range(n):
                    nbrs = self.nbrs(v)
                    c_old = int(core[v])
                    c_new = local_core(c_old, core[nbrs])
                    comp += 1
                    if c_new != c_old:
                        core[v] = c_new
                        update = True
                        upd += 1
                if sp.active:
                    sp.set(computed=n, updates=upd)
            om[0].inc()
            om[1].inc(n)
            om[2].inc(upd)
            upd_hist.append(upd)
            comp_hist.append(n)
        return self._result(core, None, iters, comp, "semicore", upd_hist,
                            comp_hist)

    # =====================================================================
    # Algorithm 4: SemiCore+
    # =====================================================================
    def semicore_plus(self, schedule: str = "seq", backend=None,
                      superstep_chunk: int | None = None,
                      device=None) -> DecompResult:
        if schedule == "batch":
            backend, superstep_chunk = self._defaults(backend, superstep_chunk)
            return run_batch(self, "semicore+", backend,
                             superstep_chunk=superstep_chunk, device=device)
        _seq_only(backend)
        n = self.n
        core = self.degrees().astype(np.int64)
        active = np.ones(n, dtype=bool)
        vmin, vmax = 0, n - 1
        comp, iters = 0, 0
        upd_hist, comp_hist = [], []
        update = True
        om = _pass_obs("semicore+", "numpy", "seq")
        while update:
            update = False
            iters += 1
            nvmin, nvmax = n - 1, 0
            upd = cpt = 0
            scan_lo = vmin
            v = vmin
            with _trace.span("superstep", cat="engine", algorithm="semicore+",
                             backend="numpy", schedule="seq",
                             index=iters) as sp:
                while v <= vmax:
                    if active[v]:
                        active[v] = False
                        nbrs = self.nbrs(v)
                        c_old = int(core[v])
                        c_new = local_core(c_old, core[nbrs])
                        cpt += 1
                        if c_new != c_old:
                            core[v] = c_new
                            upd += 1
                            for u in nbrs:
                                active[u] = True
                                u = int(u)
                                # UpdateRange (Alg. 4 lines 17-21)
                                if u > vmax:
                                    vmax = u
                                if u < v:
                                    update = True
                                    nvmin = min(nvmin, u)
                                    nvmax = max(nvmax, u)
                    v += 1
                self.reader.account_node_table_scan(scan_lo, vmax)
                if sp.active:
                    sp.set(computed=cpt, updates=upd)
            om[0].inc()
            om[1].inc(cpt)
            om[2].inc(upd)
            vmin, vmax = nvmin, nvmax
            upd_hist.append(upd)
            comp_hist.append(cpt)
            comp += cpt
        return self._result(core, None, iters, comp, "semicore+", upd_hist,
                            comp_hist)

    # =====================================================================
    # Algorithm 5: SemiCore*
    # =====================================================================
    def semicore_star(self, schedule: str = "seq", *,
                      core: np.ndarray | None = None,
                      cnt: np.ndarray | None = None,
                      vrange: tuple[int, int] | None = None,
                      backend=None, superstep_chunk: int | None = None,
                      device=None) -> DecompResult:
        """Full Algorithm 5; with (core, cnt, vrange) given, runs its lines
        4-14 as a warm-started settle loop."""
        if schedule == "batch":
            backend, superstep_chunk = self._defaults(backend, superstep_chunk)
            return run_batch(self, "semicore*", backend, core=core, cnt=cnt,
                             superstep_chunk=superstep_chunk, device=device)
        _seq_only(backend)
        n = self.n
        if core is None:
            core = self.degrees().astype(np.int64)
            cnt = np.zeros(n, dtype=np.int64)
            vmin, vmax = 0, n - 1
        else:
            if cnt is None:
                raise ValueError("a warm start needs both core and cnt")
            core = np.asarray(core, dtype=np.int64)
            cnt = np.asarray(cnt, dtype=np.int64)
            vmin, vmax = vrange if vrange is not None else (0, n - 1)
        comp, iters = 0, 0
        upd_hist, comp_hist = [], []
        update = True
        om = _pass_obs("semicore*", "numpy", "seq")
        while update:
            update = False
            iters += 1
            nvmin, nvmax = n - 1, 0
            upd = cpt = 0
            scan_lo = vmin
            v = vmin
            with _trace.span("superstep", cat="engine", algorithm="semicore*",
                             backend="numpy", schedule="seq",
                             index=iters) as sp:
                while v <= vmax:
                    if cnt[v] < core[v]:
                        nbrs = self.nbrs(v)
                        c_old = int(core[v])
                        nbr_cores = core[nbrs]
                        c_new = local_core(c_old, nbr_cores)
                        cpt += 1
                        if c_new != c_old:
                            upd += 1
                        core[v] = c_new
                        # ComputeCnt (Eq. 2)
                        cnt[v] = int((nbr_cores >= c_new).sum())
                        # UpdateNbrCnt: push decrements into (c_new, c_old]
                        push = nbrs[(nbr_cores > c_new) & (nbr_cores <= c_old)]
                        if len(push):
                            np.subtract.at(cnt, push, 1)
                        # UpdateRange over now-deficient neighbours
                        for u in nbrs:
                            u = int(u)
                            if cnt[u] < core[u]:
                                if u > vmax:
                                    vmax = u
                                if u < v:
                                    update = True
                                    nvmin = min(nvmin, u)
                                    nvmax = max(nvmax, u)
                    v += 1
                self.reader.account_node_table_scan(scan_lo, vmax)
                if sp.active:
                    sp.set(computed=cpt, updates=upd)
            om[0].inc()
            om[1].inc(cpt)
            om[2].inc(upd)
            vmin, vmax = nvmin, nvmax
            upd_hist.append(upd)
            comp_hist.append(cpt)
            comp += cpt
        return self._result(core, cnt, iters, comp, "semicore*", upd_hist,
                            comp_hist)

    def _result(self, core, cnt, iters, comp, algo, upd, cpt) -> DecompResult:
        return DecompResult(
            core=core,
            cnt=cnt,
            iterations=iters,
            node_computations=comp,
            edge_block_reads=self.reader.reads,
            node_table_reads=self.reader.node_table_reads,
            algorithm=algo,
            schedule="seq",
            updates_per_iter=upd,
            computations_per_iter=cpt,
            backend="numpy",
        )


def decompose(
    graph,
    algorithm: str = "semicore*",
    schedule: str = "batch",
    block_edges: int = DEFAULT_BLOCK_EDGES,
    pool_blocks: int = 1,
    backend=None,
    superstep_chunk: int | None = None,
    settings: "_runtime.Settings | None" = None,
    *,
    device=None,
) -> DecompResult:
    """One-call core decomposition with the chosen paper algorithm.

    ``backend`` picks the batch-schedule substrate ("cuda" | "torch" |
    "numpy" | a ComputeBackend instance); ``None`` defers to
    ``REPRO_TORCH_BACKEND`` (default "cuda").  ``device`` places a device
    backend: ``None`` is the first GPU and raises without one;
    ``device="cpu"`` runs on the host (the cuda backend through its
    kernels' plain versions).  ``superstep_chunk`` sizes the resident
    passes per host round-trip (``REPRO_TORCH_RESIDENT_CHUNK``).
    ``settings`` (a :class:`repro_torch.runtime.Settings`) supplies the
    backend and the chunk where they are left ``None`` (the environment
    still wins).
    """
    eng = HostEngine(graph, block_edges, pool_blocks=pool_blocks,
                     settings=settings)
    kw = dict(backend=backend, superstep_chunk=superstep_chunk, device=device)
    if algorithm == "semicore":
        return eng.semicore(schedule, **kw)
    if algorithm == "semicore+":
        return eng.semicore_plus(schedule, **kw)
    if algorithm == "semicore*":
        return eng.semicore_star(schedule, **kw)
    raise ValueError(f"unknown algorithm {algorithm!r}")
