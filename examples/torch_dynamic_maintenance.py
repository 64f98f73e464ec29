"""Dynamic graphs on the PyTorch port: maintain core numbers under an
edge-update stream (§V).

Compares SemiInsert and SemiInsert* (the paper's per-edge serial path)
and both against full recomputation, reproducing the qualitative claims
of Fig. 10, then settles a whole micro-batch in one grouped apply.

    PYTHONPATH=src python examples/torch_dynamic_maintenance.py [--device cpu]

Without ``--device`` the decomposition and the grouped settle run on
cuda:0; ``--device cpu`` runs the kernels' plain versions on the host.
The per-edge comparison is the numpy oracle either way.
"""
import argparse
import time

import numpy as np

from repro_torch.core import CoreMaintainer, decompose, imcore_bz
from repro_torch.core.update import Insert, UpdateBatch
from repro_torch.graph import chung_lu
from repro_torch.runtime import Settings

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device of the batch backend (default: cuda:0)")
ap.add_argument("--n", type=int, default=30_000, help="nodes")
ap.add_argument("--m", type=int, default=200_000, help="edges")
ap.add_argument("--updates", type=int, default=100,
                help="edges deleted and re-inserted")
args = ap.parse_args()

g = chung_lu(args.n, args.m, seed=1)
full = decompose(g, "semicore*", "batch", device=args.device)
print(f"initial decomposition: kmax={full.kmax}, "
      f"I/O={full.edge_block_reads} blocks")

rng = np.random.default_rng(0)
edges = g.edge_list()
picks = edges[rng.choice(len(edges), args.updates, replace=False)]

# the SemiInsert-vs-SemiInsert* comparison needs the paper's per-edge
# path, so pin the serial oracle (parallel_maint=False) on numpy
serial = Settings(parallel_maint=False, backend="numpy")
m = CoreMaintainer(g, settings=serial)
for algo in ("semiinsert", "semiinsert*"):
    m2 = CoreMaintainer(m.bg.materialize(), state=(m.core, m.cnt),
                        settings=serial)
    io = comp = 0
    t0 = time.time()
    for u, v in picks:
        m2.apply(UpdateBatch.from_pairs(deletes=[(int(u), int(v))]))
    for u, v in picks:
        s = m2.apply(UpdateBatch((Insert(int(u), int(v)),)),
                     insert_algorithm=algo)
        io += s.edge_block_reads
        comp += s.node_computations
    dt = (time.time() - t0) / (2 * len(picks))
    print(f"{algo:<12} avg {dt * 1e3:.2f} ms/op, {io / len(picks):.1f} I/Os "
          f"and {comp / len(picks):.1f} computations per insertion")
    assert np.array_equal(m2.core, imcore_bz(m2.bg.materialize()))
print(f"(one full recomputation costs {full.edge_block_reads} I/Os — "
      f"maintenance is orders of magnitude cheaper per update)")

# the grouped settle takes the whole micro-batch in one call: independent
# groups fixpoint together on the device
m3 = CoreMaintainer(m.bg.materialize(), state=(m.core, m.cnt),
                    device=args.device)
batch = UpdateBatch.from_pairs(deletes=picks)
t0 = time.time()
s = m3.apply(batch)
print(f"parallel     {len(batch)} deletes in one apply(): "
      f"{(time.time() - t0) * 1e3:.1f} ms total, {s.groups} groups "
      f"(largest {s.largest_group} nodes), {s.settle_passes} settle passes")
assert np.array_equal(m3.core, imcore_bz(m3.bg.materialize()))
