"""Time other builds of the fused superstep pair beside the shipped one.

A probe, not a path of the port.  It times, by one clock and on the same
inputs, what ``chip_smoke.py`` times for the shipped pair alone:

* the shipped kernels built with another value of a constant of
  ``csrc/fused_superstep.cu`` (``kUnroll``, the gathers a lane keeps in
  flight; ``kGroupLanes``, ``kGroupMaxDeg``, ``kWarpMaxDeg``, the bin
  rule, which the wrapper then follows);
* the superstep pair of another checkout of the port (``src=DIR``, e.g.
  the ``src`` of a ``git archive`` of an earlier commit).

The graph is drawn on the card from a seed: Chung-Lu with gamma 2.5 at
the LiveJournal-sized cell's n = 4,847,571 and 43,000,000 draws (the
distribution of ``graph.powerlaw_chunks``, another sample), deduplicated
and symmetrized, ~86 M directed edges, in seconds instead of the host
generator's minutes.  Each variant runs in a process of its own, in the
order given, holds ``row_pass`` / ``push_pass`` (semicore*) to the plain
version at the first pass and at the state entering pass 20 (reached by
the plain version), and prints one JSON line: their device times
(``chip_smoke.device_ms``), each kernel's time by the profiler, and the
whole semicore* fixpoint superstep by superstep, each timed alone as
``chip_smoke.per_superstep`` does (``chip_smoke.timed_superstep``).  On
one card:

    python3 src/repro_torch/kernels/probe_superstep.py \\
        shipped src=baseline/src kUnroll=1 shipped

writes the lines also to ``chiprun_out/probe_superstep.jsonl``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
#: constants of csrc/fused_superstep.cu a variant may set, and the
#: wrapper's name of each bin-rule constant
CONSTANTS = {"kUnroll": None, "kGroupLanes": "GROUP_LANES", "kGroupMaxDeg": "GROUP_MAX_DEG",
             "kWarpMaxDeg": "WARP_MAX_DEG"}
GRAPH = (4_847_571, 43_000_000, 2.5)  # n, draws, gamma
LATE_PASS = 20


def parse(spec: str) -> dict:
    """``"shipped"``, ``"src=DIR"`` or ``"kUnroll=2,kWarpMaxDeg=256"``."""
    if spec == "shipped":
        return {}
    out = dict(part.split("=", 1) for part in spec.split(","))
    bad = set(out) - {"src", *CONSTANTS}
    if bad or ("src" in out and len(out) > 1):
        raise ValueError(f"variant {spec!r}: src=DIR alone, or constants of "
                         f"{tuple(CONSTANTS)}")
    return out


def chung_lu_on_card(device, n: int, m: int, gamma: float, seed: int = 0):
    """(segptr int32 (n+1,), nbr int32 (E,)) of an undirected Chung-Lu
    graph drawn on the card: endpoints ~ (i + i0)^(-1/(gamma-1)) over a
    random id permutation, self loops dropped, duplicates merged."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    i0 = n ** (1.0 / (gamma - 1.0)) / 10.0 + 1.0
    w = (torch.arange(n, device=device, dtype=torch.float64) + i0) ** (
        -1.0 / (gamma - 1.0))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(n, generator=gen, device=device)

    def draw():
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        return perm[torch.searchsorted(cdf, u).clamp_(max=n - 1)]

    src, dst = draw(), draw()
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    key = torch.unique(lo * n + hi)
    lo, hi = key // n, key % n
    key = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    rows = key // n
    segptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    segptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return segptr.to(torch.int32), (key % n).to(torch.int32)


def run_one(spec: str) -> dict:
    """Time one variant in this process."""
    var = parse(spec)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [var.get("src", str(ROOT / "src")), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, fused_superstep as fsk

    consts = {k: int(v) for k, v in var.items() if k in CONSTANTS}
    if consts:  # the shipped source with these constants, built apart
        text = (_build.CSRC / "fused_superstep.cu").read_text()
        for name, value in consts.items():
            text, k = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", text)
            if k != 1:
                raise RuntimeError(f"no constant {name} in fused_superstep.cu")
            if CONSTANTS[name]:
                setattr(fsk, CONSTANTS[name], value)
        fsk.BIN_FIRST_DEGREE = (1, fsk.GROUP_MAX_DEG + 1,
                                fsk.WARP_MAX_DEG + 1, fsk.HIST_BINS)
        work = _build.BUILD_DIR / "probe" / spec.replace(",", "_")
        work.mkdir(parents=True, exist_ok=True)
        (work / "fused_superstep.cu").write_text(text)
        _build.CSRC = _build.BUILD_DIR = work

    device = torch.device("cuda", 0)
    segptr, nbr = chung_lu_on_card(device, *GRAPH)
    n = segptr.shape[0] - 1
    deg = (segptr[1:] - segptr[:-1]).long()
    star = fsk.MODE_SEMICORE_STAR
    kw = {"plan": fsk.bin_plan(segptr)} if hasattr(fsk, "bin_plan") else {}

    def step(core, cnt, active, plain=False):
        if plain:
            return fsk.fused_pass_plain(core, cnt, active, segptr, nbr,
                                        algorithm="semicore*")
        return fsk.fused_pass(core, cnt, active, segptr, nbr,
                              algorithm="semicore*", **kw)

    first = (deg.to(torch.int32), torch.zeros(n, dtype=torch.int32,
                                              device=device), deg > 0)
    state = first
    for _ in range(LATE_PASS):
        state = step(*state, plain=True)[:3]
    out = {"variant": spec, "card": cs.card_line(),
           "graph": {"n": n, "directed_edges": int(nbr.shape[0]),
                     "dmax": int(deg.max())}}
    for label, (core, cnt, active) in (("first", first), ("late", state)):
        want = fsk.row_pass_plain(star, segptr, nbr, core, cnt, active)
        got = fsk.row_pass(star, segptr, nbr, core, cnt, active, **kw)
        cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                 f"{spec}: row_pass != plain at the {label} pass")
        core2, cnt2 = want[0], want[1]
        tgt, tgt_plain = cnt2.clone(), cnt2.clone()
        fsk.push_pass(star, segptr, nbr, core, core2, active, tgt, **kw)
        fsk.push_pass_plain(star, segptr, nbr, core, core2, active, tgt_plain)
        cs.check(torch.equal(tgt, tgt_plain),
                 f"{spec}: push_pass != plain at the {label} pass")
        reps = 10 if label == "first" else 50

        def row():
            return fsk.row_pass(star, segptr, nbr, core, cnt, active, **kw)

        def push():
            return fsk.push_pass(star, segptr, nbr, core, core2, active,
                                 tgt, **kw)

        out[label] = {
            "frontier_rows": int(active.sum()),
            "frontier_edges": int(deg[active].sum()),
            "row_ms": cs.device_ms(row, reps, device),
            "push_ms": cs.device_ms(push, reps, device),
            "row_kernels_ms": {k: v / 3 for k, v in cs.device_profile(
                lambda: [row() for _ in range(3)], 8)["top_kernels_ms"]
                .items()},
            "push_kernels_ms": {k: v / 3 for k, v in cs.device_profile(
                lambda: [push() for _ in range(3)], 8)["top_kernels_ms"]
                .items()}}
    # the fixpoint, each superstep alone on the card
    state, per_pass = first, []
    while bool(state[2].any()):
        res, pairs = cs.timed_superstep(step, state, {})
        torch.cuda.synchronize(device)
        per_pass.append(min(s.elapsed_time(e) for s, e in pairs))
        state = res[:3]
    out["fixpoint"] = {"passes": len(per_pass),
                       "kmax": int(state[0].max()),
                       "device_ms_total": sum(per_pass),
                       "device_ms": per_pass}
    return out


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    for spec in argv:
        parse(spec)
    out = ROOT / "chiprun_out" / "probe_superstep.jsonl"
    out.parent.mkdir(exist_ok=True)
    failed = 0
    with out.open("w") as f:
        for spec in argv or ["shipped"]:
            proc = subprocess.run([sys.executable, __file__, "--one", spec],
                                  capture_output=True, text=True)
            line = proc.stdout.strip().splitlines()[-1:] if \
                proc.returncode == 0 else []
            if not line:
                failed += 1
                line = [json.dumps({"variant": spec, "rc": proc.returncode,
                                    "stderr": proc.stderr[-2000:]})]
            print(line[0], flush=True)
            f.write(line[0] + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
