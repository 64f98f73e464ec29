"""Out-of-core ingestion end to end on the PyTorch port: stream -> disk
tables -> decomposition on the card.

A power-law edge *stream* (never an edge array) is built into on-disk
node/edge tables by the port's external-memory builder (sorted runs,
cascaded k-way merge, streaming symmetrized scatter; peak memory O(n) +
O(chunk)), memmap-loaded, and decomposed with SemiCore* on the superstep
kernels, with and without a degree-descending relabel; then the paper's
single block buffer is set against LRU buffer pools on the numpy seq
schedule.

    PYTHONPATH=src python examples/torch_outofcore_decompose.py
    PYTHONPATH=src python examples/torch_outofcore_decompose.py --device cpu

The first runs on cuda:0 (and fails without a GPU); ``--device cpu`` runs
the kernels' plain versions on the host.
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import decompose
from repro_torch.graph import CSRGraph, build_csr, powerlaw_chunks

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device of the decompose (default cuda:0)")
ap.add_argument("--n", type=int, default=200_000)
ap.add_argument("--m", type=int, default=2_000_000, help="edge draws")
ap.add_argument("--chunk", type=int, default=1 << 18)
args = ap.parse_args()

workdir = tempfile.mkdtemp(prefix="ooc_")
try:
    def build(name, relabel="none"):
        t0 = time.perf_counter()
        stats = build_csr(
            powerlaw_chunks(args.n, args.m, gamma=2.2, seed=4,
                            chunk_edges=args.chunk),
            os.path.join(workdir, name), n=args.n, chunk_edges=args.chunk,
            relabel=relabel)
        print(f"built {name}: n={stats.n:,} m={stats.m:,} from "
              f"{stats.chunks} chunks ({stats.runs} runs, "
              f"{stats.merge_rounds} merge rounds) in "
              f"{time.perf_counter() - t0:.1f}s; node state "
              f"{stats.node_state_bytes / 1e6:.1f} MB")
        return stats, CSRGraph.load(os.path.join(workdir, name), mmap=True)

    # 1) ingest the stream out of core; 2) memmap-load and decompose
    stats, g = build("graph")
    r = decompose(g, "semicore*", "batch", backend="cuda", device=args.device)
    print(f"SemiCore* on {r.backend}: kmax={r.kmax} iters={r.iterations} "
          f"I/O={r.edge_block_reads} blocks")

    # 3) the paper's ordering lever: degree-descending ids
    stats2, g2 = build("graph_deg", relabel="degree")
    r2 = decompose(g2, "semicore*", "batch", backend="cuda",
                   device=args.device)
    if not (np.array_equal(r2.core[stats2.perm], r.core)
            and np.array_equal(r2.cnt[stats2.perm], r.cnt)
            and r2.iterations == r.iterations
            and r2.updates_per_iter == r.updates_per_iter):
        raise SystemExit("the relabeled decompose differs through perm")
    print(f"degree-relabeled: node-table reads {r.node_table_reads} -> "
          f"{r2.node_table_reads}, edge blocks {r.edge_block_reads} -> "
          f"{r2.edge_block_reads}")

    # 4) single block buffer (the paper's model) against LRU pools up to
    #    the edge table's size (only compulsory misses survive a covering
    #    pool), on the paper-faithful seq schedule
    num_blocks = -(-g.num_directed // 512)
    for pool in (1, num_blocks // 4, num_blocks):
        rp = decompose(g, "semicore*", "seq", block_edges=512,
                       pool_blocks=pool, backend="numpy")
        print(f"pool_blocks={pool:>5}: edge block reads {rp.edge_block_reads}")
finally:
    shutil.rmtree(workdir, ignore_errors=True)
