"""EMCore (Cheng et al., ICDE'11): the external-memory baseline
(Algorithm 2) of the paper's Fig. 9 comparison.

The port's own copy of ``repro/core/emcore.py``, on the host in numpy:
partition-based, top-down range computation with core upper bounds,
deposited degrees, partition write-back, and *unbounded* memory in the
worst case, the drawback SemiCore* removes.  Every result field is the
reference's.  Two shortcuts keep a round that finalizes nothing (each
level from the largest degree down to the largest core, on a graph whose
every partition holds a hub) at a few edge sweeps: the in-memory peel
strips the nodes below the round's range first instead of peeling every
level (:func:`_peel_with_deposits`), and such a round rewrites no
partition, so the next one reuses its in-memory graph.

Correctness: to finalize cores in [k_l, k_u] it suffices to peel the union
of the loaded partitions' residual subgraphs plus per-node deposited
degrees (edges to already-finalized higher-core nodes count at every
level, since those neighbours' cores exceed any value in the current
range); every node with true core >= k_l has ub >= core >= k_l and is
therefore loaded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.storage import CSRGraph, DEFAULT_BLOCK_EDGES

__all__ = ["emcore", "EMCoreResult"]


@dataclass
class EMCoreResult:
    core: np.ndarray
    rounds: int
    read_blocks: int
    write_blocks: int
    peak_memory_edges: int
    over_budget_rounds: int

    @property
    def peak_memory_bytes(self) -> int:
        return self.peak_memory_edges * 8 + len(self.core) * 17


def _peel_with_deposits(n_local, indptr, adj, dep, kl: int):
    """Peel (local CSR + deposited degrees); deposits never get removed.

    Only cores >= ``kl`` are computed: the nodes outside the kl-core are
    stripped first and left at 0.  A round reads nothing below kl (it
    finalizes ``cmem >= kl`` only), and the cores inside the kl-core are
    those of the whole peel, so the result is the reference's peel on every
    value a round uses, without peeling every level below kl.  The first
    strip wave is taken from the node table alone: only the rows of nodes
    whose degree reaches kl are read.
    """
    deg = np.diff(indptr) + dep
    core = np.zeros(n_local, dtype=np.int64)
    alive = deg >= kl
    rows = np.flatnonzero(alive)
    lens = np.diff(indptr)[rows]
    total = int(lens.sum())
    seg = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=seg[1:])
    flat = np.repeat(indptr[rows] - seg[:-1], lens) + np.arange(
        total, dtype=np.int64)
    src = np.repeat(rows, lens)
    dst = np.asarray(adj)[flat].astype(np.int64)
    keep = alive[dst]
    src, dst = src[keep], dst[keep]
    deg = dep + np.bincount(src, minlength=n_local)
    remaining = len(rows)

    def remove(f):
        nonlocal remaining, src, dst, deg
        alive[f] = False
        remaining -= int(f.sum())
        emask = f[src]
        if emask.any():
            deg -= np.bincount(dst[emask], minlength=n_local)
            keep = ~emask & alive[dst]
            src, dst = src[keep], dst[keep]

    while True:  # strip the rest of what lies below the kl-core
        f = alive & (deg < kl)
        if not f.any():
            break
        remove(f)
    k = 0
    while remaining:
        k = max(k, int(deg[alive].min()))
        while True:
            f = alive & (deg <= k)
            if not f.any():
                break
            core[f] = k
            remove(f)
    return core


def emcore(
    graph: CSRGraph,
    num_partitions: int = 16,
    memory_budget_edges: int | None = None,
    block_edges: int = DEFAULT_BLOCK_EDGES,
) -> EMCoreResult:
    n = graph.n
    deg = graph.degrees()
    total_dir = graph.num_directed
    if memory_budget_edges is None:
        memory_budget_edges = max(total_dir // 4, 4 * block_edges)

    # --- line 1: partition into ~equal-edge contiguous node ranges ----------
    bounds = [0]
    target = total_dir / num_partitions
    acc = 0
    for v in range(n):
        acc += int(deg[v])
        if acc >= target * len(bounds) and v + 1 < n:
            bounds.append(v + 1)
    bounds.append(n)
    nparts = len(bounds) - 1

    # per-partition residual adjacency (the "partitions on disk")
    parts: list[dict] = []
    for p in range(nparts):
        lo, hi = bounds[p], bounds[p + 1]
        parts.append(
            {
                "nodes": np.arange(lo, hi, dtype=np.int64),
                "indptr": graph.indptr[lo : hi + 1] - graph.indptr[lo],
                "adj": np.array(graph.adj[graph.indptr[lo] : graph.indptr[hi]]),
            }
        )

    ub = deg.astype(np.int64).copy()  # lines 2-3: ub(v) init
    dep = np.zeros(n, dtype=np.int64)  # deposited degrees
    core = np.zeros(n, dtype=np.int64)
    finalized = np.zeros(n, dtype=bool)
    read_blocks = write_blocks = 0
    peak_mem = 0
    over_budget = 0
    rounds = 0
    epoch = 0  # bumped whenever the partitions are rewritten
    gmem_key = None

    ku = int(ub.max()) if n else 0
    while ku > 0 and not finalized.all():
        rounds += 1
        # --- line 6: estimate k_l from the memory budget --------------------
        pmax = np.array(
            [int(ub[p["nodes"]].max()) if len(p["nodes"]) else -1 for p in parts]
        )
        psize = np.array([len(p["adj"]) for p in parts])
        kl = ku
        while kl > 1:
            load = psize[pmax >= kl - 1].sum()
            if load > memory_budget_edges:
                break
            kl -= 1
        sel = np.flatnonzero(pmax >= kl)
        if not len(sel):
            ku = kl - 1
            continue
        loaded_edges = int(psize[sel].sum())
        if loaded_edges > memory_budget_edges:
            over_budget += 1
        peak_mem = max(peak_mem, loaded_edges)
        read_blocks += -(-loaded_edges // block_edges)

        # --- lines 7-9: build G_mem and peel with deposits -------------------
        # edges to non-loaded nodes are dropped: those neighbors have
        # ub < kl, hence core < kl <= any value finalized this round; they
        # can never support a node at level >= kl (exact for this range).
        # G_mem depends on the selection and the partitions only, so a
        # round that loads what the last one loaded, after a round that
        # finalized nothing, reuses it.
        key = (sel.tobytes(), epoch)
        if gmem_key != key:
            gmem_key = key
            gnodes = np.concatenate([parts[p]["nodes"] for p in sel])
            local = np.full(n, -1, dtype=np.int64)
            local[gnodes] = np.arange(len(gnodes))
            srcs, dsts = [], []
            for p in sel:
                P = parts[p]
                s = np.repeat(P["nodes"], np.diff(P["indptr"]))
                d = P["adj"]
                keep = local[d] >= 0
                srcs.append(local[s[keep]])
                dsts.append(local[d[keep]])
            src_l = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
            dst_l = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
            loc_indptr = np.zeros(len(gnodes) + 1, dtype=np.int64)
            np.cumsum(np.bincount(src_l, minlength=len(gnodes)),
                      out=loc_indptr[1:])
            order = np.argsort(src_l, kind="stable")
            loc_adj = dst_l[order]
        cmem = _peel_with_deposits(len(gnodes), loc_indptr, loc_adj,
                                   dep[gnodes], kl)

        # --- lines 9-12: finalize cores in [kl, ku]; update ub/dep ----------
        fin_local = cmem >= kl
        fin_nodes = gnodes[fin_local]
        core[fin_nodes] = cmem[fin_local]
        finalized[fin_nodes] = True
        ub[gnodes[~fin_local]] = np.minimum(ub[gnodes[~fin_local]], kl - 1)

        # remove finalized nodes from *all* partitions, deposit degrees,
        # write partitions back (lines 10-13); with nothing finalized every
        # partition stays as it is
        if len(fin_nodes):
            epoch += 1
            rem_mask_global = np.zeros(n, dtype=bool)
            rem_mask_global[fin_nodes] = True
            for P in parts:
                if not len(P["nodes"]):
                    continue
                keep_node = ~rem_mask_global[P["nodes"]]
                s = np.repeat(P["nodes"], np.diff(P["indptr"]))
                d = P["adj"]
                gone = rem_mask_global[d]
                src_kept = ~rem_mask_global[s]
                # deposit: kept nodes count their removed neighbors forever
                deposit_src = s[gone & src_kept]
                if len(deposit_src):
                    np.add.at(dep, deposit_src, 1)
                ekeep = src_kept & ~gone
                s, d = s[ekeep], d[ekeep]
                new_nodes = P["nodes"][keep_node]
                relocal = np.full(n, -1, dtype=np.int64)
                relocal[new_nodes] = np.arange(len(new_nodes))
                cnts = np.bincount(relocal[s], minlength=len(new_nodes)) \
                    if len(s) else np.zeros(len(new_nodes), np.int64)
                new_indptr = np.zeros(len(new_nodes) + 1, dtype=np.int64)
                np.cumsum(cnts, out=new_indptr[1:])
                order = np.argsort(relocal[s], kind="stable") if len(s) \
                    else np.empty(0, np.int64)
                P["nodes"] = new_nodes
                P["indptr"] = new_indptr
                P["adj"] = d[order].astype(np.int64)
        for p in sel:  # the loaded partitions are written back
            write_blocks += -(-len(parts[p]["adj"]) // block_edges)
        ku = kl - 1

    return EMCoreResult(
        core=core,
        rounds=rounds,
        read_blocks=read_blocks,
        write_blocks=write_blocks,
        peak_memory_edges=peak_mem,
        over_budget_rounds=over_budget,
    )
