"""Time ``CoreMaintainer.apply`` of one mixed batch at full width.

A probe, not a path of the port.  It builds the kernels and
``chip_smoke.py``'s LiveJournal-sized graph (n = 4,847,571, ~86 M
directed edges), decomposes it on "cuda", draws a mixed batch of the
given size (``graph.update_cases.mixed_batch``, ``chip_smoke``'s seed and
delete odds) and applies it from that state once for each path named
(``chip_smoke.mixed_legs``: ``parallel_cuda``, ``serial_cuda``,
``parallel_per_probe``), every (core, cnt) equal to the first's.  Each
apply prints ``chip_smoke.timed_apply``'s record (wall, host split,
supersteps and their device ms, groups, fallbacks, block reads, peak
memory) as one JSON line, also appended to
``chiprun_out/probe_maintain.jsonl``.  On one card:

    python3 src/repro_torch/core/probe_maintain.py 10000 parallel_cuda
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv) -> int:
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import CudaBackend, UpdateBatch, decompose
    from repro_torch.graph.update_cases import mixed_batch

    if not torch.cuda.is_available():
        print("probe_maintain: CUDA is not available", file=sys.stderr)
        return 2
    updates, legs = int(argv[0]), argv[1:] or ["parallel_cuda"]
    device = torch.device("cuda", 0)
    cs.phase_build()
    t = time.perf_counter()
    g = cs.powerlaw_graph(*cs.FULL)
    gen_s = time.perf_counter() - t
    r = decompose(g, "semicore*", backend=CudaBackend(device=device))
    batch = UpdateBatch.from_wire(mixed_batch(
        g, updates, seed=cs.MAINTAIN_SEED, p_delete=cs.MAINTAIN_P_DELETE))
    recs = cs.apply_legs(device, g, r, batch, legs)
    recs.pop("_last")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "probe_maintain.jsonl", "a") as f:
        for leg, rec in recs.items():
            line = json.dumps({"updates": updates, "leg": leg,
                               "host_build_s": gen_s,
                               "card": cs.card_line(), **rec})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
