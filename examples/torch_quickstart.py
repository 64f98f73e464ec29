"""Quickstart on the PyTorch port: core decomposition with the paper's
three semi-external algorithms on the paper's running example (Fig. 1)
and a synthetic graph, then maintenance under edge updates.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Without ``--device`` the batch decomposition and the settles run on
cuda:0 (the fused superstep kernels); ``--device cpu`` runs their plain
versions on the host.  The sequential schedule of Fig. 1 runs on the host
either way.
"""
import argparse

import numpy as np

from repro_torch.core import CoreMaintainer, decompose, imcore_bz
from repro_torch.core.update import Delete, Insert, UpdateBatch
from repro_torch.graph import chung_lu, paper_example_graph

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device of the batch backend (default: cuda:0)")
ap.add_argument("--n", type=int, default=50_000, help="synthetic nodes")
ap.add_argument("--m", type=int, default=400_000, help="synthetic edges")
args = ap.parse_args()

# --- the paper's Fig. 1 graph -----------------------------------------------
g = paper_example_graph()
print("Fig. 1 graph:", g.n, "nodes,", g.m, "edges")
for algo in ("semicore", "semicore+", "semicore*"):
    r = decompose(g, algo, schedule="seq", block_edges=16, backend="numpy")
    print(f"  {algo:<10} cores={r.core.tolist()} iters={r.iterations} "
          f"computations={r.node_computations}")
# SemiCore:36, SemiCore+:23, SemiCore*:11 — exactly Examples 4.1/4.2/4.3.

# --- a power-law graph, all engines agree ------------------------------------
g = chung_lu(args.n, args.m, seed=0)
ref = imcore_bz(g)
r = decompose(g, "semicore*", schedule="batch", device=args.device)
assert np.array_equal(r.core, ref)
print(f"\nchung_lu({args.n}, {args.m}) on {r.backend}: kmax={r.kmax} "
      f"iters={r.iterations} I/O={r.edge_block_reads} blocks  "
      f"memory={r.memory_bytes / 1e6:.1f} MB (vs in-memory CSR "
      f"{(g.num_directed * 4 + g.n * 24) / 1e6:.1f} MB)")

# --- maintain under updates ---------------------------------------------------
m = CoreMaintainer(g, device=args.device)
e = g.edge_list()[min(12345, g.m - 1)]
s = m.apply(UpdateBatch((Delete(int(e[0]), int(e[1])),)))
print(f"delete edge: {s.node_computations} computations, "
      f"{s.edge_block_reads} I/Os, {s.num_changed} cores changed")
s = m.apply(UpdateBatch((Insert(int(e[0]), int(e[1])),)))
print(f"insert edge: {s.node_computations} computations, "
      f"{s.edge_block_reads} I/Os, {s.num_changed} cores changed")
back = np.array_equal(m.core, ref)
print("cores back to original:", back)
assert back

# a whole micro-batch settles in one call — deletes and inserts interleave
# in submission order, and stats report the independent groups settled
picks = g.edge_list()[:4]
batch = UpdateBatch.from_pairs(deletes=picks[:2], inserts=picks[:2])
s = m.apply(batch)
print(f"batch of {len(batch)} ops: algorithm={s.algorithm} "
      f"groups={s.groups} noops={s.num_noops}")
assert np.array_equal(m.core, ref)
