"""Time the embedding bag's designs, and the gather time of its rows, at
MIND's serve_bulk bags.

A probe, not a path of the port.  Each variant draws the serve_bulk bags
on the card (2,097,152 bags x 16 slots, uniform over N rows of a D = 64
float32 table, seeded, so every variant at one N reads the same index
stream), runs in a process of its own, in the order given, and prints one
JSON line (also appended to ``chiprun_out/probe_embedding_bag.jsonl``).
A variant is ``shipped`` or comma-separated parts:

* ``gather``: the gather time (``csrc/probe/gather_rows.cu``), a kernel
  that reads the same rows with the bag kernel's loads and walk and writes
  one float a bag, so its time is that of these row reads alone in this
  design (held to a sum of the same rows in torch ops); ``gather=row``:
  the same rows a thread a (bag, slot), all of a row's 16-byte words in
  flight;
* ``N=<rows>``: the table's rows (default 100,000: MIND's profile table);
* ``B=<bags>``: the bags (default 2,097,152; serve_p99 sends 4,096 and
  retrieval_cand 8, timed queued behind a busy wait, ``chip_smoke.device_ms``,
  as a launch of a few microseconds would time the host otherwise);
* ``kChunk=<slots>`` (row loads in flight a lane), ``kChunkSmall=<slots>``
  (the same below one wave of the card), ``kMinBlocks=<blocks>`` (a
  register cap on the ``kChunk`` instance; 1 leaves ptxas free),
  ``kThreads=<threads>``: the shipped source (or the gather's, which has
  ``kChunk`` and ``kThreads``) built with another value of that constant.

Each variant is timed (CUDA events, 20 launches after a warm-up) in turns
with the shipped kernel and, when ``baseline/src`` holds an earlier
checkout's port, with that checkout's kernel, all at the variant's N; each
bag is held bit for bit to the slot-order sum
(``ref.embedding_bag_slot_order``).  A bag build that is not is not timed:
its line gives the values that differ and, from a one-hot table whose
bags hold every slot once, how many times each slot was added (the
census).  On one card:

    python3 src/repro_torch/kernels/probe_embedding_bag.py gather,N=25000 \\
        gather,N=50000 gather gather=row gather,N=200000 shipped kChunk=4
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
CONSTANTS = ("kChunk", "kChunkSmall", "kMinBlocks", "kThreads")
GATHERS = {"": "gr_gather", "row": "gr_row_gather"}
BAGS, SLOTS, D = 2_097_152, 16, 64
ROWS = 100_000
REPS = 20


def parse(spec: str) -> dict:
    """``"shipped"`` or parts such as ``"gather,N=25000,kChunk=4"``;
    ``gather`` is None (a bag build) or the gather kernel's C entry."""
    out = {"gather": None, "N": ROWS, "B": BAGS, "consts": {}}
    if spec == "shipped":
        return out
    for part in spec.split(","):
        key, eq, value = part.partition("=")
        if key == "gather" and value in GATHERS and (eq == "") == (value == ""):
            out["gather"] = GATHERS[value]
        elif key in ("N", "B") and value:
            out[key] = int(value)
        elif key in CONSTANTS and value:
            out["consts"][key] = int(value)
        else:
            raise ValueError(f"variant {spec!r}: part {part!r} is none of "
                             f"gather, gather=row, N=, B=, "
                             f"{', '.join(CONSTANTS)}")
    return out


def build_variant(source: Path, consts: dict, tag: str) -> Path:
    """``source`` with these constants, built apart under the build
    directory; the shipped source as it is when there are none."""
    from repro_torch.kernels import _build

    text = source.read_text()
    for name, value in consts.items():
        text, k = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{value};", text)
        if k != 1:
            raise RuntimeError(f"no constant {name} in {source.name}")
    work = _build.BUILD_DIR / "probe" / tag
    work.mkdir(parents=True, exist_ok=True)
    (work / source.name).write_text(text)
    csrc = _build.CSRC
    _build.CSRC = work
    try:
        return _build.build(source.stem)
    finally:
        _build.CSRC = csrc


def census(run, device, bags: int = 200_000) -> list:
    """How many times a bag build adds each slot's row: ``bags`` (more
    than one wave of the card) each holding rows 0..15 in slot order, of a
    table whose row l is 1 at column l, summed.  The distinct count rows,
    the commonest first, with the bags that show each."""
    import torch

    table = torch.eye(SLOTS, D, device=device)
    idx = torch.arange(SLOTS, dtype=torch.int32, device=device).repeat(bags, 1)
    adds = run(table, idx, "sum")[:, :SLOTS]
    rows, counts = torch.unique(adds, dim=0, return_counts=True)
    order = counts.argsort(descending=True)[:4]
    return [{"adds": rows[k].tolist(), "bags": int(counts[k])} for k in order]


def run_one(spec: str) -> dict:
    """Time one variant in this process."""
    v = parse(spec)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, embedding_bag as ebk
    from repro_torch.kernels.ref import embedding_bag_slot_order

    device = torch.device("cuda", 0)
    gen = torch.Generator(device).manual_seed(0)
    N, B = v["N"], v["B"]
    table = torch.randn(N, D, generator=gen, device=device)
    idx = torch.randint(0, N, (BAGS, SLOTS), generator=gen, device=device,
                        dtype=torch.int32)[:B]
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    plan = ebk.card_plan(table, idx)
    tag = spec.replace(",", "_").replace("=", "")
    want = embedding_bag_slot_order(table, idx, "mean")

    if v["gather"]:
        path = build_variant(_build.CSRC / "probe" / "gather_rows.cu",
                             v["consts"], tag)
        lib = ctypes.CDLL(str(path))
        entry = getattr(lib, v["gather"])
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tpb = (plan["tpb"],) if v["gather"] == "gr_gather" else ()
        entry.argtypes = [vp, vp, ll, i, i, *[i] * len(tpb), vp, vp]
        entry.restype = i
        out = torch.empty(B, device=device)

        def variant():
            err = entry(table.data_ptr(), idx.data_ptr(), B, SLOTS, D, *tpb,
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gather launch failed: CUDA error {err}")
            return out

        variant()
        sums = torch.empty(B, device=device)  # the rows' values, in slices
        for s in range(0, B, 131072):
            sums[s:s + 131072] = table[idx[s:s + 131072].long()].sum(
                dim=(1, 2))
        err = float((out - sums).abs().max())
        cs.check(err <= 1e-3 + 1e-4 * float(sums.abs().max()),
                 f"{spec}: gather != the rows' sum ({err})")
        held = {"max_abs_err": err}
    else:
        consts = v["consts"]
        path = build_variant(_build.CSRC / "embedding_bag.cu", consts, tag) \
            if consts else _build.build(ebk.KERNEL_SOURCE)
        lib = ebk._bind(ctypes.CDLL(str(path)))
        shipped_lib = ebk._lib

        def run(tab, ind, mode="mean"):
            ebk._lib = lambda: lib
            try:
                return ebk.embedding_bag(tab, ind, mode=mode)
            finally:
                ebk._lib = shipped_lib

        def variant():
            return run(table, idx)

        got = variant()
        if not torch.equal(got, want):
            diff = (got - want).abs()
            return {"variant": spec, "card": cs.card_line(), "N": N,
                    "bags": B, "bit_identical": False,
                    "differing": int((diff > 0).sum()),
                    "values": want.numel(), "max_diff": float(diff.max()),
                    "census": census(run, device), "library": path.name,
                    "ptxas": _build.resource_usage(path)}
        held = {"bit_identical": True}

    def shipped():
        return ebk.embedding_bag(table, idx, mode="mean")

    cs.check(torch.equal(shipped(), want), "shipped: != the slot-order sum")
    timed = {"variant": variant, "shipped": shipped}
    base = cs.baseline_module("embedding_bag")
    if base is not None:
        def baseline():
            return base.embedding_bag(table, idx, mode="mean")

        cs.check(torch.equal(baseline(), want),
                 "baseline: != the slot-order sum")
        timed["baseline"] = baseline
    ms = {name: [] for name in timed}
    timer, reps = (cs.cuda_ms, REPS) if B >= 100_000 else (cs.device_ms, 200)
    for order in (list(timed), list(timed)[::-1]):  # in turns
        for name in order:
            ms[name].append(timer(timed[name], reps, device))
    ebk.raise_bad_index(device)
    gathered = 4 * B * SLOTS * D
    return {"variant": spec, "card": cs.card_line(), "N": N,
            "table_bytes": 4 * N * D, "l2_bytes": l2, "bags": B,
            "slots": SLOTS, "D": D, "gathered_bytes": gathered,
            "plan": plan, "library": path.name,
            "ptxas": _build.resource_usage(path), **held,
            "ms": {k: min(t) for k, t in ms.items()}, "ms_runs": ms,
            "gathered_tb_per_s": {k: gathered / min(t) / 1e9
                                  for k, t in ms.items()}}


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    for spec in argv:
        parse(spec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    failed = 0
    for spec in argv or ["shipped"]:
        proc = subprocess.run([sys.executable, __file__, "--one", spec],
                              capture_output=True, text=True)
        line = proc.stdout.strip().splitlines()[-1:] if \
            proc.returncode == 0 else []
        if not line or json.loads(line[0]).get("bit_identical") is False:
            failed += 1
        if not line:
            line = [json.dumps({"variant": spec, "rc": proc.returncode,
                                "stderr": proc.stderr[-2000:]})]
        print(line[0], flush=True)
        with open(out / "probe_embedding_bag.jsonl", "a") as f:
            f.write(line[0] + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
