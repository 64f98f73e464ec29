"""Time other builds of the segment-sum kernels beside the shipped one.

A probe, not a path of the port.  It runs ``chip_smoke.segsum_entries``
(block flags with their list, the skipping sum over the list and the sum
over every block, D = 1 int32, 512-edge blocks, each held to its plain
version, timed in turns with the kernels of a checkout under
``baseline/src`` when there is one) for:

* the shipped kernels built with another value of a constant of
  ``csrc/segsum.cu`` (``kUnits``, the 16-byte words a lane loads a step;
  ``kThreads``, the threads of a block);
* the shipped kernels as they are (``shipped``).

The graph is ``probe_superstep.chung_lu_on_card``'s (the LiveJournal-sized
cell's shape, ~86 M directed edges, drawn on the card in seconds); the
two states are the first pass's first h-index probe and the state
entering pass 20 of the semicore* fixpoint (reached by the fused
superstep's plain version).  Each variant runs in a process of its own,
in the order given, and prints one JSON line.  On one card:

    python3 src/repro_torch/kernels/probe_segsum.py shipped kUnits=2 shipped
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
CONSTANTS = ("kUnits", "kThreads")
LATE_PASS = 20


def parse(spec: str) -> dict:
    """``"shipped"`` or ``"kUnits=2,kThreads=128"``."""
    if spec == "shipped":
        return {}
    out = dict(part.split("=", 1) for part in spec.split(","))
    if set(out) - set(CONSTANTS):
        raise ValueError(f"variant {spec!r}: constants of {CONSTANTS}")
    return {k: int(v) for k, v in out.items()}


class CardGraph:
    """What ``segsum_entries`` reads of a graph."""

    def __init__(self, segptr):
        self.n = segptr.shape[0] - 1
        self.num_directed = int(segptr[-1])
        self._deg = (segptr[1:] - segptr[:-1]).cpu().numpy()

    def degrees(self):
        return self._deg


def run_one(spec: str) -> dict:
    """Time one variant in this process."""
    consts = parse(spec)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(HERE)]
    import torch

    import chip_smoke as cs
    from probe_superstep import GRAPH, chung_lu_on_card
    from repro_torch.kernels import _build, fused_superstep as fsk

    if consts:  # the shipped source with these constants, built apart
        text = (_build.CSRC / "segsum.cu").read_text()
        for name, value in consts.items():
            text, k = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", text)
            if k != 1:
                raise RuntimeError(f"no constant {name} in segsum.cu")
        work = _build.BUILD_DIR / "probe" / spec.replace(",", "_")
        work.mkdir(parents=True, exist_ok=True)
        (work / "segsum.cu").write_text(text)
        _build.CSRC = _build.BUILD_DIR = work

    device = torch.device("cuda", 0)
    segptr, nbr = chung_lu_on_card(device, *GRAPH)
    g = CardGraph(segptr)
    deg = torch.as_tensor(g.degrees(), device=device)
    rows = torch.repeat_interleave(
        torch.arange(g.n, dtype=torch.int32, device=device), deg,
        output_size=g.num_directed)
    state = (deg.to(torch.int32), torch.zeros(g.n, dtype=torch.int32,
                                             device=device), deg > 0)
    for _ in range(LATE_PASS):
        state = fsk.fused_pass_plain(*state, segptr, nbr,
                                     algorithm="semicore*")[:3]
    late = {"core": state[0], "cnt": state[1], "active": state[2]}
    names = ("block_flags", "segment_sum_active", "segment_sum")
    cs.LATE_PASS = LATE_PASS
    entries = cs.segsum_entries(g, device, {"nbr": nbr, "rows": rows},
                                dict.fromkeys(names, 0), {"late": late})
    lib = _build.build("segsum")
    keep = ("ms", "bound_ms", "baseline_ms", "active_blocks")
    return {"variant": spec, "card": cs.card_line(),
            "graph": {"n": g.n, "directed_edges": g.num_directed},
            "ptxas": _build.resource_usage(lib),
            **{e["name"]: {
                "first": {"ms": e["ms"], "bound_ms": e["bound_ms"],
                          "baseline_ms": (e["baseline"] or {}).get("ms")},
                "late": {k: e["late_probe"][k] for k in keep}}
               for e in entries}}


def main(argv: list) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    for spec in argv:
        parse(spec)
    failed = 0
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
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
