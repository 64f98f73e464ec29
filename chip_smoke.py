#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build      compile every kernels/csrc/*.cu with nvcc, all sources at once
  parity     each CUDA kernel against its plain torch version: the superstep
             pair on the seeded CASES, every mode, bit for bit; the segment
             sums over dtypes x widths x block sizes x frontiers (int32
             exact, float tolerances of the reference's kernel tests)
  small      powerlaw graph (n=200,000, 2,000,000 draws): semicore,
             semicore+, semicore* and a warm settle on the "cuda" backend,
             every result field equal to the plain version on the card, core
             equal to imcore_peel; the same runs per probe
             (CudaBackend(fused=False)) and on "torch", equal to "cuda"
  full       the main path: a LiveJournal-sized powerlaw graph (n=4,847,571,
             43,000,000 draws, ~86M directed edges resident on the card),
             built once for every full-width phase; decompose(...,
             "semicore*") on "cuda" against the plain version
  per_probe  the same decompose per probe and on "torch", each equal to the
             "cuda" result; the segment-sum kernel's block-read counter
             equal to (num_probes + 1) x kernel_blocks_active
  segment_sum  segment_sum((core[nbr] >= core[rows]), rows, n) at full
             width equal to the result's cnt (Eq. 2)

then the kernels line (launches on each kernel's path, error against the
plain version, times and bounds), the card's name and power limit, and the
result line.  Any mismatch raises and exits non-zero.  Needs CUDA, nvcc and
the repository's ``src/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMALL = (200_000, 2_000_000)     # (n, powerlaw draws)
FULL = (4_847_571, 43_000_000)   # LiveJournal's node count, ~86M directed edges
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12     # 32-bit rate outside the tensor cores (same sheet)
FUSED_REPLACES = "src/repro/kernels/fused_superstep.py:202"  # _superstep_kernel
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_superstep.cu"
SEGSUM_SOURCE = "src/repro_torch/kernels/csrc/segsum.cu"
SEGSUM_REPLACES = {
    "segment_sum_active": "src/repro/kernels/segsum_active.py:21",  # _kernel
    "segment_sum": "src/repro/kernels/segsum.py:25",  # _segsum_block_kernel
    # the block-activity mask that feeds segsum_active._kernel's scalar
    # prefetch (computed in jnp by make_superstep_segsum)
    "block_flags": "src/repro/kernels/ops.py:111",
}
FLAGS_THREADS = 256  # kThreads of csrc/segsum.cu: block_flags' stride


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def same_result(a, b, what: str) -> None:
    """Every DecompResult field the port holds to the reference; a "torch"
    result ``a`` reports no kernel blocks, as the reference's "xla" does."""
    check(np.array_equal(a.core, b.core), f"{what}: core")
    check((a.cnt is None) == (b.cnt is None)
          and (a.cnt is None or np.array_equal(a.cnt, b.cnt)), f"{what}: cnt")
    fields = ["iterations", "node_computations", "updates_per_iter",
              "computations_per_iter", "edge_block_reads", "node_table_reads"]
    if a.backend == "torch":
        check(a.kernel_blocks_active == a.kernel_blocks_skipped == 0,
              f"{what}: torch reports kernel blocks")
    else:
        fields += ["kernel_blocks_active", "kernel_blocks_skipped"]
    for f in fields:
        check(getattr(a, f) == getattr(b, f), f"{what}: {f}")


def reset_launch_counts() -> None:
    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.kernels import segsum as ssk, segsum_active as ssa

    for mod in (fsk, ssk, ssa):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.kernels import segsum as ssk, segsum_active as ssa

    return {**fsk.LAUNCHES, **ssk.LAUNCHES, **ssa.LAUNCHES}


def powerlaw_graph(n: int, m: int):
    from repro_torch.graph import CSRGraph, powerlaw_chunks

    edges = np.concatenate(list(powerlaw_chunks(n=n, m=m, gamma=2.5, seed=0)))
    return CSRGraph.from_edges(n, edges)


def bound(nbytes: int, ops: int) -> tuple:
    """Least time on the card (ms) and what sets it: the bytes over the
    memory rate or the int32 operations over the 32-bit rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn, reps: int, device) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phases
def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs], "nvcc": _build.find_nvcc()})


def phase_parity(device) -> None:
    """Kernel against plain version on the CASES, every mode."""
    import torch

    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.kernels.cases import CASES, superstep_case

    rng = np.random.default_rng(0)
    checked = 0
    for (n, m, _tile, iso, frontier) in CASES:
        c = superstep_case(n, m, iso, frontier, rng)
        t = {k: torch.as_tensor(v if k != "seg_ptr" else v.astype(np.int32),
                                device=device) for k, v in c.items()}
        table = (t["seg_ptr"], t["nbr"])
        for algo in ("semicore", "semicore+", "semicore*"):
            got = fsk.fused_pass(t["core"], t["cnt"], t["active"], *table,
                                 algorithm=algo)
            want = fsk.fused_pass_plain(t["core"], t["cnt"], t["active"],
                                        *table, algorithm=algo)
            for name, g, w in zip(("core2", "cnt2", "active2", "upd"),
                                  got, want):
                check(torch.equal(g, w), f"parity {algo} n={n} "
                      f"{frontier}: {name}")
            checked += 1
        got = fsk.fused_hindex(t["core"], t["active"], *table)
        want = fsk.fused_hindex_plain(t["core"], t["active"], *table)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"parity hindex n={n} {frontier}")
        got = fsk.fused_counts(t["core"], t["thr"], t["active"], *table)
        want = fsk.fused_counts_plain(t["core"], t["thr"], t["active"],
                                      *table)
        check(torch.equal(got, want), f"parity counts n={n} {frontier}")
        checked += 2
    torch.cuda.synchronize(device)
    emit({"phase": "parity", "cases": len(CASES), "checks": checked,
          "modes": ["semicore", "semicore+", "semicore*", "hindex",
                    "counts"], "tolerance": 0,
          "segment_sums": parity_segsum(device)})


def parity_segsum(device) -> dict:
    """The segment-sum kernels against their plain versions on seeded
    rows with rows longer than a block, empty rows and a partial last
    block."""
    import torch

    from repro_torch.kernels import segsum as ssk, segsum_active as ssa
    from repro_torch.kernels.cases import (SEGSUM_BLOCKS, SEGSUM_DTYPES,
                                           SEGSUM_FRONTIERS, SEGSUM_TOL,
                                           SEGSUM_WIDTHS, segsum_frontier,
                                           segsum_rows, segsum_values)

    def close(got, want, dtype, what):
        rtol, atol = SEGSUM_TOL[dtype]
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{what}: dtype/shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()), what)
        return float(err.max()) if err.numel() else 0.0

    rng = np.random.default_rng(2)
    n, checked, worst = 300, 0, {}
    for dtype in SEGSUM_DTYPES:
        for D in SEGSUM_WIDTHS:
            rows_h = segsum_rows(rng, n, 4000)
            rows = torch.as_tensor(rows_h, device=device)
            vals = torch.as_tensor(segsum_values(rng, len(rows_h), D, dtype),
                                   device=device).to(getattr(torch, dtype))
            for be in SEGSUM_BLOCKS:
                what = f"parity segment_sum {dtype} D={D} be={be}"
                err = close(ssk.segment_sum(vals, rows, n, be),
                            ssk.segment_sum_plain(vals, rows, n, be), dtype,
                            what)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                checked += 1
                for kind in SEGSUM_FRONTIERS:
                    act = torch.as_tensor(segsum_frontier(kind, rng, n),
                                          device=device)
                    flags = ssa.block_flags(rows, act, be)
                    check(torch.equal(flags, ssa.block_flags_plain(rows, act,
                                                                   be)),
                          f"{what} {kind}: flags")
                    err = close(
                        ssa.segsum_active(vals, rows, flags, n, be),
                        ssa.segsum_active_plain(vals, rows, flags, n, be),
                        dtype, f"{what} {kind}: segment_sum_active")
                    worst[dtype] = max(worst[dtype], err)
                    checked += 2
    torch.cuda.synchronize(device)
    return {"checks": checked, "dtypes": list(SEGSUM_DTYPES),
            "widths": list(SEGSUM_WIDTHS), "block_edges": list(SEGSUM_BLOCKS),
            "frontiers": list(SEGSUM_FRONTIERS), "max_abs_err": worst,
            "tolerance": {k: list(v) for k, v in SEGSUM_TOL.items()}}


def other_substrates(device, run, ref, what: str) -> dict:
    """``run(backend)`` per probe and on "torch", each held to ``ref``;
    returns walls and the per-probe kernels' launches."""
    import torch

    from repro_torch.core import CudaBackend, TorchBackend

    out = {}
    for label, backend in (("per_probe", CudaBackend(device=device,
                                                     fused=False)),
                           ("torch", TorchBackend(device=device))):
        reset_launch_counts()
        t = time.perf_counter()
        r = run(backend)
        torch.cuda.synchronize(device)
        out[f"{label}_wall_s"] = time.perf_counter() - t
        same_result(r, ref, f"{what} {label}")
        launches = launch_counts()
        if label == "per_probe":
            for name in ("block_flags", "segment_sum_active"):
                check(launches[name] > 0, f"{what}: {name} never launched")
            out["per_probe_launches"] = {
                k: launches[k] for k in ("block_flags", "segment_sum_active")}
        else:
            check(not any(launches.values()),
                  f"{what}: torch launched a kernel of the port")
    return out


def phase_small(device, n: int, m: int) -> None:
    import torch

    from repro_torch.core import CudaBackend, HostEngine, decompose, warm_settle
    from repro_torch.core.imcore import imcore_peel
    from repro_torch.graph import BufferedGraph

    t0 = time.perf_counter()
    g = powerlaw_graph(n, m)
    gen_s = time.perf_counter() - t0
    expect = imcore_peel(g)
    out = {"phase": "small", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "kmax": int(expect.max()),
           "host_build_s": gen_s, "runs": {}}
    star = None
    for algo in ("semicore", "semicore+", "semicore*"):
        reset_launch_counts()
        t = time.perf_counter()
        r = decompose(g, algo, backend=CudaBackend(device=device))
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        launches = {k: v for k, v in launch_counts().items() if v}
        check(launches.get("row_pass", 0) > 0,
              f"{algo}: row_pass never launched")
        if algo != "semicore":
            check(launches.get("push_pass", 0) > 0,
                  f"{algo}: push_pass never launched")
        rp = decompose(g, algo, backend=CudaBackend(device=device, plain=True))
        same_result(r, rp, f"small {algo}")
        check(np.array_equal(r.core, expect), f"small {algo}: core != peel")
        out["runs"][algo] = {"passes": r.iterations, "wall_s": wall,
                             "launches": launches,
                             **other_substrates(
                                 device, lambda b: decompose(g, algo,
                                                             backend=b),
                                 r, f"small {algo}")}
        star = r if algo == "semicore*" else star
    # warm settle after edge deletions and insertions
    rng = np.random.default_rng(1)
    bg = BufferedGraph(g)
    edges = g.edge_list()
    for i in rng.choice(len(edges), size=200, replace=False):
        bg.delete_edge(*map(int, edges[i]))
    inserted = sum(bg.insert_edge(int(u), int(v))
                   for u, v in rng.integers(0, g.n, size=(200, 2)))
    reset_launch_counts()
    rw = warm_settle(HostEngine(bg), star.core, inserted,
                     CudaBackend(device=device))
    launches = {k: v for k, v in launch_counts().items() if v}
    rwp = warm_settle(HostEngine(bg), star.core, inserted,
                      CudaBackend(device=device, plain=True))
    same_result(rw, rwp, "small warm_settle")
    check(launches.get("row_pass", 0) > 0,
          "warm_settle: row_pass never launched")
    out["runs"]["warm_settle"] = {
        "passes": rw.iterations, "inserted": inserted, "launches": launches,
        **other_substrates(
            device, lambda b: warm_settle(HostEngine(bg), star.core,
                                          inserted, b),
            rw, "small warm_settle")}
    # last: materialize() flushes the buffer, which rewrites the base CSR
    # (and so the block layout every later engine would charge)
    check(np.array_equal(rw.core, imcore_peel(bg.materialize())),
          "small warm_settle: core != peel")
    emit(out)


def phase_full(device, g, gen_s: float) -> tuple:
    """The main path at full width: returns (the fused kernels' launches on
    it, its result)."""
    import torch

    from repro_torch.core import CudaBackend, decompose
    from repro_torch.obs import trace

    out = {"phase": "full", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "host_build_s": gen_s}

    t = time.perf_counter()
    decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["cold_wall_s"] = time.perf_counter() - t

    # the main path: launch counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t = time.perf_counter()
    r = decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["warm_wall_s"] = time.perf_counter() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["passes"] = r.iterations
    out["kmax"] = r.kmax
    for name in ("row_pass", "push_pass"):
        check(launches.get(name, 0) > 0, f"main path: {name} never launched")

    # device time of every superstep (row pass + push pass + frontier ops)
    be = CudaBackend(device=device)
    events = time_supersteps(be)
    trace.clear_trace()
    trace.start_trace()
    t = time.perf_counter()
    rt = decompose(g, "semicore*", backend=be)
    torch.cuda.synchronize(device)
    traced_wall = time.perf_counter() - t
    trace.stop_trace()
    spans = trace.get_collector().to_chrome()["traceEvents"]
    per_pass = [s.elapsed_time(e) for s, e in events]
    same_result(rt, r, "full timed rerun")
    out["superstep_ms_total"] = sum(per_pass)
    out["supersteps_launched"] = len(per_pass)
    out["superstep_ms_first"] = per_pass[0]
    out["superstep_ms_per_pass"] = sum(per_pass[:r.iterations]) / r.iterations

    def span_s(name):
        return sum(e["dur"] for e in spans if e["name"] == name) / 1e6

    # where the traced decompose's wall goes: structure build + upload,
    # chunks (device work, the per-chunk sync and the host replay), rest
    out["breakdown_s"] = {
        "wall": traced_wall,
        "structure": span_s("resident.structure"),
        "chunks": span_s("resident.chunk"),
        "supersteps_on_device": sum(per_pass) / 1e3,
    }

    t = time.perf_counter()
    rp = decompose(g, "semicore*", backend=CudaBackend(device=device,
                                                       plain=True))
    torch.cuda.synchronize(device)
    out["plain_wall_s"] = time.perf_counter() - t
    same_result(r, rp, "full semicore*")
    emit(out)
    return launches, r


def time_supersteps(backend) -> list:
    """Wrap the backend's resident superstep in CUDA events; returns the
    list that collects one (start, end) pair per superstep."""
    import torch

    events = []
    resident_ops = backend.resident_ops

    def timed_ops(*a):
        step, counts = resident_ops(*a)

        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = step(*args, **kw)
            e.record()
            events.append((s, e))
            return res

        return timed, counts

    backend.resident_ops = timed_ops
    return events


def phase_per_probe(device, g, ref) -> dict:
    """The same decompose per probe (the segment-sum kernels' path) and on
    "torch", each held to the fused result; the block-read counter against
    the paper's block discipline.  Returns the per-probe path's launches."""
    import torch

    from repro_torch.core import CudaBackend, TorchBackend, decompose
    from repro_torch.kernels import segsum as ssk

    # every pass launches num_probes h-index probes and one count over the
    # same flags; num_probes covers the largest initial core bound, dmax
    dmax = int(g.degrees().max())
    num_probes = max(1, int(np.ceil(np.log2(dmax + 2))))
    out = {"phase": "per_probe", "num_probes": num_probes, "runs": {}}
    launches = None
    for label, backend in (("per_probe", CudaBackend(device=device,
                                                     fused=False)),
                           ("torch", TorchBackend(device=device))):
        events = time_supersteps(backend)
        torch.cuda.reset_peak_memory_stats(device)
        ssk.reset_blocks_read()
        # this path's launch counts: set to 0 just before, read just after
        reset_launch_counts()
        t = time.perf_counter()
        r = decompose(g, "semicore*", backend=backend)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        run_launches = {k: v for k, v in launch_counts().items() if v}
        same_result(r, ref, f"full {label}")
        per_pass = [s.elapsed_time(e) for s, e in events]
        run = {"wall_s": wall, "passes": r.iterations,
               "launches": run_launches,
               "max_memory_allocated":
                   torch.cuda.max_memory_allocated(device),
               "superstep_ms_total": sum(per_pass),
               "supersteps_launched": len(per_pass),
               "superstep_ms_first": per_pass[0]}
        if label == "per_probe":
            launches = run_launches
            for name in ("block_flags", "segment_sum_active"):
                check(launches.get(name, 0) > 0,
                      f"per-probe path: {name} never launched")
            read = ssk.blocks_read(device)
            want = (num_probes + 1) * r.kernel_blocks_active
            check(read == want, f"blocks read {read} != (num_probes + 1) x "
                  f"kernel_blocks_active = {want}")
            run.update(blocks_read=read,
                       kernel_blocks_active=r.kernel_blocks_active,
                       kernel_blocks_skipped=r.kernel_blocks_skipped)
        else:
            check(not run_launches, "torch launched a kernel of the port")
        out["runs"][label] = run
    emit(out)
    return launches


def device_tables(g, device) -> dict:
    """The flat CSR on the card: segptr (n+1,), nbr and rows (E,), int32."""
    import torch

    deg = torch.as_tensor(g.degrees(), device=device)
    n = g.n
    return {
        "segptr": torch.as_tensor(g.indptr.astype(np.int32), device=device),
        "nbr": torch.as_tensor(g.adj, device=device),
        "rows": torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=device), deg,
            output_size=g.num_directed),
    }


def phase_segment_sum(device, g, ref, tables) -> dict:
    """Eq. 2 at full width through the plain segment sum: the final cnt of
    the semicore* result.  Returns the launches on this path."""
    import torch

    from repro_torch.kernels import segsum as ssk

    core = torch.as_tensor(ref.core.astype(np.int32), device=device)
    rows, nbr = tables["rows"], tables["nbr"]
    vals = (core[nbr] >= core[rows]).to(torch.int32)
    reset_launch_counts()
    cnt = ssk.segment_sum(vals, rows, g.n)
    torch.cuda.synchronize(device)
    launches = {k: v for k, v in launch_counts().items() if v}
    check(launches.get("segment_sum", 0) > 0,
          "segment_sum path: segment_sum never launched")
    check(np.array_equal(cnt.cpu().numpy(), ref.cnt),
          "segment_sum at full width != semicore* cnt")
    emit({"phase": "segment_sum", "n": g.n, "directed_edges": int(len(vals)),
          "equals_cnt": True, "launches": launches})
    return launches


def flags_reads(rows, active, block_edges: int) -> tuple:
    """(rows read, distinct node flags read) by ``block_flags`` on this
    frontier: each of a block's ``FLAGS_THREADS`` threads strides the block
    and stops after its first active row."""
    import torch

    E = rows.shape[0]
    e = torch.arange(E, device=rows.device)
    pos = e % block_edges
    stride = pos // FLAGS_THREADS
    thread = (e // block_edges) * FLAGS_THREADS + pos % FLAGS_THREADS
    hit = active[rows.long()]
    nb = -(-E // block_edges)
    first = torch.full((nb * FLAGS_THREADS,), block_edges,
                       dtype=torch.int64, device=rows.device)
    first.scatter_reduce_(0, thread[hit], stride[hit], "amin")
    read = stride <= first[thread]
    return int(read.sum()), int(torch.unique(rows[read]).numel())


def kernel_entries(g, device, tables, launches) -> list:
    """Time each kernel and its plain version at the first semicore* pass
    of the main path (every node with an edge active, cnt = 0); the segment
    sums at that pass's first h-index probe (D = 1, int32)."""
    import torch

    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.kernels import segsum as ssk, segsum_active as ssa

    star = fsk.MODE_SEMICORE_STAR
    deg = g.degrees()
    n = g.n
    segptr, nbr, rows = tables["segptr"], tables["nbr"], tables["rows"]
    core = torch.as_tensor(deg.astype(np.int32), device=device)
    cnt = torch.zeros(n, dtype=torch.int32, device=device)
    active_h = deg > 0
    active = torch.as_tensor(active_h, device=device)

    def row():
        return fsk.row_pass(star, segptr, nbr, core, cnt, active)

    def row_plain():
        return fsk.row_pass_plain(star, segptr, nbr, core, cnt, active)

    got, want = row(), row_plain()
    row_err = max(int((got[i] - want[i]).abs().max()) for i in range(2))
    row_err = max(row_err, abs(int(got[2]) - int(want[2])))
    core2, cnt2 = got[0], got[1]
    e_row = int(deg[active_h].sum())
    row_bytes = 4 * (n + 1) + n + 4 * n + 4 * n + 4 * e_row + 8 * n + 4
    row_ms = cuda_ms(row, 10, device)
    row_plain_ms = cuda_ms(row_plain, 2, device)

    tgt = cnt2.clone()
    fsk.push_pass(star, segptr, nbr, core, core2, active, tgt)
    tgt_plain = cnt2.clone()
    fsk.push_pass_plain(star, segptr, nbr, core, core2, active, tgt_plain)
    push_err = int((tgt - tgt_plain).abs().max())
    pushing = active_h & (core2.cpu().numpy() != deg)
    e_push = int(deg[pushing].sum())
    push_bytes = 4 * (n + 1) + n + 4 * n + 4 * n + 4 * e_push + 8 * n
    scratch = cnt2.clone()
    push_ms = cuda_ms(lambda: fsk.push_pass(star, segptr, nbr, core, core2,
                                            active, scratch), 10, device)
    push_plain_ms = cuda_ms(lambda: fsk.push_pass_plain(
        star, segptr, nbr, core, core2, active, scratch), 2, device)
    check(row_err == 0 and push_err == 0, "kernel != plain at full width")

    entries = []
    for name, err, ms, pms, nbytes, ops in (
            ("row_pass", row_err, row_ms, row_plain_ms, row_bytes, e_row),
            ("push_pass", push_err, push_ms, push_plain_ms, push_bytes,
             e_push)):
        bms, by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": FUSED_SOURCE,
            "replaces": FUSED_REPLACES, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "parity": "bit-identical",
            "shape": {"n": n, "directed_edges": g.num_directed,
                      "active_edges": ops, "bytes": nbytes}})

    # the segment sums: the first probe's indicator, mid = (deg + 1) // 2,
    # over every block (all active), D = 1 int32, at the engine's block
    be = 512
    E = g.num_directed
    mid = (core + 1) // 2
    vals = (core[nbr] >= mid[rows]).to(torch.int32)
    nb = -(-E // be)
    flags = ssa.block_flags(rows, active, be)
    flags_plain = ssa.block_flags_plain(rows, active, be)
    flags_err = int((flags - flags_plain).abs().max())
    rows_read, nodes_read = flags_reads(rows, active, be)

    def library():  # one PyTorch call computing the same sum
        return torch.zeros(n, dtype=torch.int32, device=device).index_add_(
            0, rows, vals)

    lib_out = library()
    timed = {
        "block_flags": (
            lambda: ssa.block_flags(rows, active, be),
            lambda: ssa.block_flags_plain(rows, active, be), flags_err,
            # the rows its early exit reads, the node flags they name (one
            # byte each), the flags written
            4 * rows_read + nodes_read + 4 * nb, rows_read, None),
        "segment_sum_active": (
            lambda: ssa.segsum_active(vals, rows, flags, n, be),
            lambda: ssa.segsum_active_plain(vals, rows, flags, n, be),
            int((ssa.segsum_active(vals, rows, flags, n, be)
                 - ssa.segsum_active_plain(vals, rows, flags, n, be))
                .abs().max()),
            # rows and vals once (8 B/edge), the flags, the output's zero
            # fill and write
            8 * E + 4 * nb + 8 * n, E, library),
        "segment_sum": (
            lambda: ssk.segment_sum(vals, rows, n, be),
            lambda: ssk.segment_sum_plain(vals, rows, n, be),
            int((ssk.segment_sum(vals, rows, n, be)
                 - ssk.segment_sum_plain(vals, rows, n, be)).abs().max()),
            8 * E + 8 * n, E, library),
    }
    check(all(t[2] == 0 for t in timed.values()),
          "segment-sum kernels != plain at full width")
    check(torch.equal(ssk.segment_sum(vals, rows, n, be), lib_out),
          "segment_sum != index_add_ at full width")
    for name, (fn, plain, err, nbytes, ops, lib) in timed.items():
        bms, by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": SEGSUM_SOURCE,
            "replaces": SEGSUM_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": cuda_ms(fn, 20, device),
            "plain_ms": cuda_ms(plain, 3, device), "bound_ms": bms,
            "bound_by": by,
            "library_ms": None if lib is None else cuda_ms(lib, 20, device),
            "parity": "bit-identical",
            "shape": {"n": n, "directed_edges": E, "block_edges": be,
                      "blocks": nb, "active_blocks": int(flags.sum()),
                      "D": 1, "dtype": "int32", "bytes": nbytes,
                      **({"rows_read": rows_read, "nodes_read": nodes_read}
                         if name == "block_flags" else {})}})
    return entries


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    phase_parity(device)
    phase_small(device, *SMALL)
    # the LiveJournal-sized graph, built once for every full-width phase
    t0 = time.perf_counter()
    g = powerlaw_graph(*FULL)
    gen_s = time.perf_counter() - t0
    launches, r = phase_full(device, g, gen_s)
    launches.update(phase_per_probe(device, g, r))
    tables = device_tables(g, device)
    launches.update(phase_segment_sum(device, g, r, tables))
    emit({"kernels": kernel_entries(g, device, tables, launches)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
