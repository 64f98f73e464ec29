#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build   compile every kernels/csrc/*.cu with nvcc, all sources at once
  parity  each CUDA kernel against its plain torch version on the seeded
          CASES, every mode, bit for bit
  small   powerlaw graph (n=200,000, 2,000,000 draws): semicore, semicore+,
          semicore* and a warm settle on the "cuda" backend, every result
          field equal to the plain version on the card, core equal to
          imcore_peel
  full    the main path: a LiveJournal-sized powerlaw graph (n=4,847,571,
          43,000,000 draws, ~86M directed edges resident on the card),
          decompose(..., "semicore*") on "cuda" against the plain version

then the kernels line (launches on the main path, error against the plain
version, times and bounds), the card's name and power limit, and the result
line.  Any mismatch raises and exits non-zero.  Needs CUDA, nvcc and the
repository's ``src/``.
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
REPLACES = "src/repro/kernels/fused_superstep.py:202"  # _superstep_kernel
SOURCE = "src/repro_torch/kernels/csrc/fused_superstep.cu"


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def same_result(a, b, what: str) -> None:
    """Every DecompResult field the port holds to the reference."""
    check(np.array_equal(a.core, b.core), f"{what}: core")
    check((a.cnt is None) == (b.cnt is None)
          and (a.cnt is None or np.array_equal(a.cnt, b.cnt)), f"{what}: cnt")
    for f in ("iterations", "node_computations", "updates_per_iter",
              "computations_per_iter", "edge_block_reads", "node_table_reads",
              "kernel_blocks_active", "kernel_blocks_skipped"):
        check(getattr(a, f) == getattr(b, f), f"{what}: {f}")


def powerlaw_graph(n: int, m: int):
    from repro_torch.graph import CSRGraph, powerlaw_chunks

    edges = np.concatenate(list(powerlaw_chunks(n=n, m=m, gamma=2.5, seed=0)))
    return CSRGraph.from_edges(n, edges)


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
                    "counts"], "tolerance": 0})


def phase_small(device, n: int, m: int) -> None:
    import torch

    from repro_torch.core import CudaBackend, HostEngine, decompose, warm_settle
    from repro_torch.core.imcore import imcore_peel
    from repro_torch.graph import BufferedGraph
    from repro_torch.kernels import fused_superstep as fsk

    t0 = time.perf_counter()
    g = powerlaw_graph(n, m)
    gen_s = time.perf_counter() - t0
    expect = imcore_peel(g)
    out = {"phase": "small", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "kmax": int(expect.max()),
           "host_build_s": gen_s, "runs": {}}
    star = None
    for algo in ("semicore", "semicore+", "semicore*"):
        fsk.reset_launch_counts()
        t = time.perf_counter()
        r = decompose(g, algo, backend=CudaBackend(device=device))
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        launches = dict(fsk.LAUNCHES)
        check(launches["row_pass"] > 0, f"{algo}: row_pass never launched")
        if algo != "semicore":
            check(launches["push_pass"] > 0,
                  f"{algo}: push_pass never launched")
        rp = decompose(g, algo, backend=CudaBackend(device=device, plain=True))
        same_result(r, rp, f"small {algo}")
        check(np.array_equal(r.core, expect), f"small {algo}: core != peel")
        out["runs"][algo] = {"passes": r.iterations, "wall_s": wall,
                             "launches": launches}
        star = r if algo == "semicore*" else star
    # warm settle after edge deletions and insertions
    rng = np.random.default_rng(1)
    bg = BufferedGraph(g)
    edges = g.edge_list()
    for i in rng.choice(len(edges), size=200, replace=False):
        bg.delete_edge(*map(int, edges[i]))
    inserted = sum(bg.insert_edge(int(u), int(v))
                   for u, v in rng.integers(0, g.n, size=(200, 2)))
    fsk.reset_launch_counts()
    rw = warm_settle(HostEngine(bg), star.core, inserted,
                     CudaBackend(device=device))
    launches = dict(fsk.LAUNCHES)
    rwp = warm_settle(HostEngine(bg), star.core, inserted,
                      CudaBackend(device=device, plain=True))
    same_result(rw, rwp, "small warm_settle")
    check(np.array_equal(rw.core, imcore_peel(bg.materialize())),
          "small warm_settle: core != peel")
    check(launches["row_pass"] > 0, "warm_settle: row_pass never launched")
    out["runs"]["warm_settle"] = {"passes": rw.iterations,
                                  "inserted": inserted, "launches": launches}
    emit(out)


def phase_full(device, n: int, m: int) -> list:
    """The main path at full width; returns the kernels line's entries."""
    import torch

    from repro_torch.core import CudaBackend, decompose
    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    g = powerlaw_graph(n, m)
    gen_s = time.perf_counter() - t0
    out = {"phase": "full", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "host_build_s": gen_s}

    t = time.perf_counter()
    decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["cold_wall_s"] = time.perf_counter() - t

    # the main path: launch counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    fsk.reset_launch_counts()
    t = time.perf_counter()
    r = decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["warm_wall_s"] = time.perf_counter() - t
    launches = dict(fsk.LAUNCHES)
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["passes"] = r.iterations
    out["kmax"] = r.kmax
    for name, count in launches.items():
        check(count > 0, f"main path: {name} never launched")

    # device time of every superstep (row pass + push pass + frontier ops)
    be = CudaBackend(device=device)
    inner = be.fused_pass
    events = []

    def timed(*a, **k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        res = inner(*a, **k)
        e.record()
        events.append((s, e))
        return res

    be.fused_pass = timed
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
    return kernel_entries(g, device, launches)


def kernel_entries(g, device, launches) -> list:
    """Time each kernel and its plain version at the first semicore* pass
    of the main path (every node with an edge active, cnt = 0)."""
    import torch

    from repro_torch.kernels import fused_superstep as fsk

    star = fsk.MODE_SEMICORE_STAR
    deg = g.degrees()
    n = g.n
    segptr = torch.as_tensor(g.indptr.astype(np.int32), device=device)
    nbr = torch.as_tensor(g.adj, device=device)
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

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / INT32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
            else "operations"

    entries = []
    for name, err, ms, pms, nbytes, ops in (
            ("row_pass", row_err, row_ms, row_plain_ms, row_bytes, e_row),
            ("push_pass", push_err, push_ms, push_plain_ms, push_bytes,
             e_push)):
        bms, by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "parity": "bit-identical",
            "shape": {"n": n, "directed_edges": g.num_directed,
                      "active_edges": ops, "bytes": nbytes}})
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
    kernels = phase_full(device, *FULL)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
