"""Web-scale-style decomposition on the PyTorch port: on-disk graph,
pluggable compute backend, sharded execution, checkpoint and restart.

Builds an RMAT web-crawl-like graph, stores it as the on-disk node/edge
tables, decomposes it memmapped with the semi-external host engine on the
chosen backend, runs the shard backend's ``distributed_decompose``,
checkpoints a budgeted prefix of it (any superstep's core is a valid upper
bound) and proves that a warm restart from the checkpoint converges to
the same fixpoint.

    PYTHONPATH=src python examples/torch_webscale_decomposition.py \
        [--backend numpy|torch|cuda|shard] [--num-shards N] [--device cpu]

``--backend shard`` cuts the edge table into contiguous node-range shards,
one per listed device, runs the fused superstep kernels on every shard and
gathers the owned core slices once a superstep.  Without ``--device`` the
shards go one per visible GPU (``--num-shards`` may not exceed them); with
``--device cuda:0`` or ``--device cpu`` all of them go on that device, so
one card or the host runs any shard count (the CPU through the kernels'
plain versions).
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import (ShardedBackend, decompose,
                              distributed_decompose, imcore_peel)
from repro_torch.graph import CSRGraph, rmat

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--backend", default="shard",
                choices=["numpy", "torch", "cuda", "shard"])
ap.add_argument("--num-shards", type=int, default=None,
                help="shards for --backend shard (default: one a GPU, or "
                "one on --device)")
ap.add_argument("--device", default=None,
                help="torch device of every shard / of a device backend "
                "(default: the GPUs)")
ap.add_argument("--scale", type=int, default=17, help="RMAT scale (2**scale "
                "nodes, 12 edges a node)")
args = ap.parse_args()


def shard_devices():
    """The shard backend's device list: --device repeated once a shard,
    else None (one shard a visible GPU)."""
    if args.device is None:
        return None
    return [args.device] * (args.num_shards or 1)


workdir = tempfile.mkdtemp(prefix="webscale_")
try:
    # 1) build + store the graph on disk (the paper's edge/node tables)
    g = rmat(args.scale, 12, seed=3)
    g.save(os.path.join(workdir, "graph"))
    g = CSRGraph.load(os.path.join(workdir, "graph"), mmap=True)
    print(f"graph: n={g.n:,} 2m={g.num_directed:,} (memmapped from disk)")

    # 2) the semi-external host engine on the selected backend
    if args.backend == "shard":
        backend = ShardedBackend(num_shards=args.num_shards,
                                 devices=shard_devices())
    else:
        backend = args.backend
    t0 = time.perf_counter()
    r = decompose(g, "semicore*", "batch", backend=backend,
                  device=None if args.backend == "shard" else args.device)
    print(f"SemiCore* on {r.backend}: kmax={r.kmax} iters={r.iterations} "
          f"I/O={r.edge_block_reads} blocks in "
          f"{time.perf_counter() - t0:.2f}s; node-state memory "
          f"{r.memory_bytes / 1e6:.1f} MB")
    if args.backend == "shard":
        print(f"  {r.num_shards} shard(s), rectangular-layout padding "
              f"{r.shard_pad_edges} edge slots "
              f"({100.0 * r.shard_pad_edges / max(1, g.num_directed):.1f}% "
              "of 2m; minimax-balanced contiguous cuts)")
    expect = imcore_peel(g)
    assert np.array_equal(r.core, expect)

    # 3) the shard engine, then a checkpoint of a budgeted prefix
    devices = shard_devices()
    core, iters = distributed_decompose(g, devices=devices)
    assert np.array_equal(core, expect)
    print(f"shard engine: {iters} supersteps, equal to IMCore")
    budget = max(2, iters // 2)
    partial, done = distributed_decompose(g, devices=devices,
                                          max_supersteps=budget)
    ckpt = os.path.join(workdir, "ckpt.npz")
    np.savez(ckpt + ".tmp.npz", core=partial.astype(np.int32), step=done)
    os.replace(ckpt + ".tmp.npz", ckpt)  # atomic: a crash keeps the old one
    print(f"checkpointed after {done} supersteps (upper bounds still valid)")

    # 4) restart warm from the checkpoint
    with np.load(ckpt) as state:
        core0 = state["core"]
    core2, extra = distributed_decompose(g, devices=devices, core0=core0)
    assert np.array_equal(core2, expect)
    print(f"warm restart finished in {extra} further supersteps: exact")
finally:
    shutil.rmtree(workdir, ignore_errors=True)
