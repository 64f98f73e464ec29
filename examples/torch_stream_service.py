"""Streaming core-graph service end to end on the PyTorch port (§V as a
long-lived process).

A CoreService ingests a live insert/delete stream in micro-batches, each
settled on the superstep kernels, while serving coreness / k-core / top-k
queries from epoch-versioned views; a read replica bootstraps from the
snapshot and tails the write-ahead log; then the writer "crashes" and
recovers from its WAL + node-state snapshot without recomputing the
decomposition from scratch.

    PYTHONPATH=src python examples/torch_stream_service.py
    PYTHONPATH=src python examples/torch_stream_service.py --device cpu

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
from repro_torch.graph import chung_lu
from repro_torch.stream import CoreReplica, CoreService, mixed_stream

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device of the settles (default cuda:0)")
ap.add_argument("--n", type=int, default=10_000)
ap.add_argument("--m", type=int, default=60_000)
ap.add_argument("--updates", type=int, default=1_000)
ap.add_argument("--batch", type=int, default=100)
ap.add_argument("--workdir", default=None,
                help="where the WAL and snapshots go (default: a temporary "
                     "directory, removed at the end)")
args = ap.parse_args()

g = chung_lu(args.n, args.m, seed=1)
stream, _ = mixed_stream(g, args.updates, seed=0)
tmp = tempfile.mkdtemp(prefix="core_stream_", dir=args.workdir)
paths = dict(wal_path=os.path.join(tmp, "wal.log"),
             snapshot_dir=os.path.join(tmp, "snaps"))
try:
    svc = CoreService(g, snapshot_every=4, device=args.device, **paths)
    print(f"service up on {svc.maintainer.backend.device}: n={args.n}, "
          f"m={args.m}, degeneracy={svc.degeneracy()}, epoch 0")
    svc.snapshot()
    replica = CoreReplica(device=args.device, **paths)

    t0 = time.time()
    for i in range(0, args.updates, args.batch):
        s = svc.ingest(stream[i:i + args.batch])
        top = svc.top_k(3)
        print(f"epoch {s.epoch:>2}: +{s.num_applied_inserts}/"
              f"-{s.num_applied_deletes} edges, {s.num_changed} cores "
              f"changed, {s.edge_block_reads} block I/Os, top-3 "
              f"{top.tolist()} (core {svc.coreness(top).tolist()})")
    rate = svc.service_stats()["updates_applied"] / (time.time() - t0)
    print(f"sustained {rate:.0f} updates/s on this host; cache hit rate "
          f"{svc.cache.hits / max(svc.cache.hits + svc.cache.misses, 1):.2f}")
    replica.sync()
    assert replica.lag() == 0
    assert np.array_equal(replica.coreness(np.arange(args.n)),
                          svc.coreness(np.arange(args.n)))
    print(f"replica at epoch {replica.epoch}, lag 0, replies equal")

    svc.close()  # --- crash here: everything below rebuilds from disk ------
    t0 = time.time()
    svc2, rec = CoreService.recover(device=args.device, **paths)
    print(f"recovered epoch {rec.recovered_epoch} from snapshot@"
          f"{rec.snapshot_epoch} + {rec.replayed_batches} WAL batches in "
          f"{time.time() - t0:.2f}s (settle: {rec.settle_node_computations} "
          f"node computations)")

    ref = decompose(svc2.bg.materialize(), "semicore*", "batch",
                    device=args.device)
    assert np.array_equal(svc2.maintainer.core, ref.core)
    assert np.array_equal(svc2.maintainer.cnt, ref.cnt)
    assert np.array_equal(svc2.maintainer.core, svc.maintainer.core)
    print(f"recovered state exact (== full decompose, {ref.node_computations} "
          f"computations avoided per restart)")
    svc2.close()
finally:
    shutil.rmtree(tmp, ignore_errors=True)
