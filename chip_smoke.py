#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build      compile every kernels/csrc/*.cu with nvcc, all sources at once
  parity     each CUDA kernel against its plain torch version: the superstep
             pair on the seeded CASES, every mode, bit for bit; the segment
             sums over dtypes x widths x block sizes x frontiers (int32
             exact, float tolerances of the reference's kernel tests)
  small      powerlaw graph (n=200,000, 2,000,000 draws): semicore,
             semicore+, semicore* and a warm settle on the "cuda" backend,
             every result field equal to the plain version on the card, core
             equal to imcore_peel; the same runs per probe
             (CudaBackend(fused=False)) and on "torch", equal to "cuda";
             the seven update families (graph/update_cases.py) through
             CoreMaintainer.apply on "cuda", per probe, "torch" and the
             plain version, each (core, cnt) equal to the numpy per-edge
             oracle (SemiDelete*, SemiInsert*, SemiInsert) bit for bit;
             EMCore (the external-memory baseline) with its core equal to
             imcore_peel, its rounds, block reads and writes and peak
             memory beside semicore*'s block reads and node-state bytes
  full       the main path: a LiveJournal-sized powerlaw graph (n=4,847,571,
             43,000,000 draws, ~86M directed edges resident on the card),
             built once for every full-width phase; decompose(...,
             "semicore*") on "cuda" against the plain version; each of its
             supersteps timed alone on the card, with its frontier's rows
             and edges and its bound (``per_superstep``)
  per_probe  the same decompose per probe and on "torch", each equal to the
             "cuda" result; the segment-sum kernel's block-read counter
             equal to (num_probes + 1) x kernel_blocks_active; the per-probe
             decompose once more under the profiler, its device time split
             between the segment-sum kernels and the rest
  outofcore  the semi-external path at full width: the same powerlaw
             stream built into on-disk tables by build_csr (default chunk,
             in a child process, this script with --ooc-build-child, that
             reports its sampled peak RSS), memmap-loaded and held
             array-equal to the in-memory graph, loaded afresh and
             decomposed on "cuda" with every result field equal to the
             main path's, the host RSS sampled over the decompose; the
             relabel="degree" build of the small phase's stream the same
             way (cut from full width: 259 s of host time there), held to
             the small graph and its result through perm; each superstep
             of the decomposes timed alone (the node-order lever), block
             and node-table reads with and without the relabel
  segment_sum  segment_sum((core[nbr] >= core[rows]), rows, n) at full
             width equal to the result's cnt (Eq. 2)
  maintain   edge-update maintenance at full width, from the main path's
             (core, cnt): 100 edges deleted in one batch, settled masked
             fused and per probe, each equal to a fresh decompose of the
             graph without them; re-inserted in a second batch, landing on
             the main path's result exactly; a batch of no-ops that
             rebuilds no structure; a light batch (100 deletes, 100
             inserts whose candidate sets stay under the group cap) and a
             mixed batch of 300 updates (45% deletes), each applied in
             parallel on "cuda", serially on "cuda" (one warm_settle) and
             in parallel per probe, the three equal and equal to a fresh
             decompose of the materialised graph.  The light batch's
             parallel legs must settle masked; each leg prints the path it
             took (the mixed batch's parallel legs fall back to
             warm_settle: a component past the cap).  The mixed batch is
             cut from 10,000: one parallel apply of 10,000 spends ~290 s
             planning on the host, of 1,000 44-76 s (core/probe_maintain.py
             times any size).  Each
             apply prints its wall and host split (structural apply,
             planning, structure rebuild and upload, device settle), its
             supersteps' device ms, rounds, groups and fallbacks, block
             reads, peak device memory and peak host RSS
  stream     the streaming core service at full width, on the main path's
             graph and state: CoreWriter (WAL with fsync, a snapshot every
             4 batches, 2 kept, in a temporary directory under chiprun_out/;
             the serial settle, one warm_settle a batch: the default
             parallel plan took 17-27 s a batch and fell back anyway)
             ingests 5 micro-batches of 128 (one mixed_batch draw of 768
             distinct updates), a query burst after each (coreness and
             in_kcore of 1,000 seeded nodes one call each, top_k(100),
             kcore_members at the degeneracy, degeneracy()); CoreReplica
             bootstraps from the epoch-4 snapshot plus WAL record 5; batch
             6 goes in and the replica syncs to lag 0; the writer is dropped
             without a snapshot and CoreWriter.recover restores it from the
             snapshot plus records 5-6 (warm restart).  Writer, replica and
             recovered writer hold equal (core, cnt), equal to a fresh
             decompose of the final graph, and equal replies with equal
             watermarks.  Prints each batch's wall, settle path and span
             split, the query latency p50/p99 by kind, the snapshot save
             and manifest-check seconds, the bootstrap, sync and recovery
             walls and the superstep pair's launches
  shard      the shard backend at full width on the main path's graph:
             decompose(..., "semicore*") over [cuda:0] (S = 1) and
             [cuda:0] * 4 (S = 4; one shard a card too when more are
             visible), each equal to the main path's result in every field
             but the kernel-block tallies and run again with each
             superstep queued behind a busy-wait (device ms); S = 4 on the
             kernels' plain versions, equal in every field; from the main
             path's (core, cnt) a 100-edge delete through
             CoreMaintainer.apply and a warm_settle of the graph less those
             edges, on the shards and on "torch" (which counts updates as
             the shard does), equal in every field.  Prints each run's
             wall, supersteps, their ms and the gather's a superstep
             (CUDA events around the backend's superstep and gather), the
             host split by span, per-shard edges, shard_pad_edges and peak
             device memory
  mind       full-width MIND (configs/mind.py, seeded weights, item table
             256 MB) serving the three recsys cells of configs/shapes.py
             (serve_p99: 512 users, 100 requests; serve_bulk: 262,144 users;
             retrieval_cand: 1 user against 1,000,000 items, top 100) with
             the profile bags on the embedding-bag kernel, each held to the
             same serving with the plain bag on the card
  lm_serve   full-width Qwen3-0.6B (751,632,384 seeded parameters, bf16)
             behind ServeEngine(batch_slots=8, max_len=32768): 8 prompts of
             512 tokens, then 32 greedy tokens, on the flash-decode kernels;
             replayed teacher-forced beside the plain attention, every
             step's logits and greedy tokens compared
  lm_prefill Qwen3-0.6B's cache-free forward: serve_prefill on lm_serve's
             8 prompts held to the engine's logits after the last prompt
             token; the prefill_32k cell at batch 2 (cut from 32),
             S = 32,768, through chunked_attention, timed with its peak
             memory; one layer's chunked attention at S = 32,768 held on
             its last 1,024 rows to a masked float32 softmax over every
             key.  Then Qwen3-14B at full depth (40 layers, G = 5) behind
             ServeEngine: 8 prompts of 64 tokens, 16 greedy tokens, flash
             decode under every layer, each decode step's logits held to
             the cache-free forward
  lm_moe     DeepSeek-V3-671B (MLA latent caches, 256 experts top-8 and a
             shared expert; 61 layers cut to 3, the dense one and 2
             routed) and Arctic-480B (128 experts top-2 beside a dense
             MLP, G = 7; 35 layers cut to 2) at full width, one after the
             other: the same serving and hold (the cache-free side at a
             capacity that drops nothing, positions routed otherwise
             counted), then serve_prefill at B = 1, S = 4,096 (cut from
             32 x 32,768), timed, with the share of assignments dropped
             at the published capacity factor
  train      training at full width through the port's train step
             (launch/steps.py: autograd then AdamW): MIND's train_batch
             (65,536 users, five steps; step 0's loss and every gradient
             leaf held to the same step with the plain bag, profile_embed's
             gradient non-zero, the bag kernel launched once a step's
             forward), the bag's forward and backward timed at that shape;
             Qwen3-0.6B's train_4k with the batch cut from 256 to 8 (4
             microbatches of 2), three steps, step 0's loss held to the
             no-grad forward and the repeated batch's loss falling;
             DeepSeek-V3 cut to its dense layer and MTP module, 1 x 4,096,
             int8 moments, two steps; a reduced Qwen3-0.6B TrainLoop
             crashed after 6 steps and resumed for 4 from its checkpoint,
             its losses equal to an uninterrupted run's.  Each prints ms a
             step, tokens or users a second, peak device memory and the
             loss curve
  gnn        the GNN zoo at full width through build_step and make_source
             (the reference's cells, uncut; plain torch, no kernel): GCN
             on full_graph_sm (Cora's 2,708 nodes, 1,433 features),
             GraphSAGE on minibatch_lg (1,024 seeds, fanout 15-10, steps
             0-2 of the sampler) and on ogb_products (2,449,030 nodes,
             80,408,244 directed edges; its source drawn by a child
             process, this script with --gnn-source-child, started before
             the mind phase), SchNet and EGNN on molecule (128 x 30
             atoms), three steps each; step 0's loss and every gradient
             leaf held to the same step on the CPU (ogb_products: 64 rows'
             logits to a float64 host forward over their two-hop balls),
             the repeated batch's loss falling; a TrainLoop("gcn-cora",
             reduced=False) crashed after 6 steps and resumed for 4, equal
             to an uninterrupted run.  Each run prints ms a step, edges a
             second, peak device memory, the source's host seconds and the
             losses

The parity phase also holds the embedding-bag and flash-decode kernels to
their plain versions over the reference's sweeps (kernels/cases.py), flash
decode also at every boundary of its split rule and at cache_len <= 0.

then the kernels line (launches on each kernel's path, on the
maintain path (``maintain_launches``), on the out-of-core path
(``outofcore_launches``), on the stream path (``stream_launches``),
on the shard path (``shard_launches``, its runs but the timing reruns),
on Qwen3-14B's decode (``lm_prefill_launches``), on Arctic's
(``lm_moe_launches``), on MIND's train steps (``train_launches``;
the bag's figures at the train shape under ``train_batch``) and on the
GNN runs (``gnn_launches``, 0: the GNN path has no kernel),
error against the plain version,
times and bounds; the superstep pair and the segment sums
also at the state entering pass 20; the embedding bag also bit for bit
against the slot-order sum, with its rate of gathered rows and at the
small batches of serve_p99 and retrieval_cand; beside the kernels of an
earlier checkout's port under ``baseline/`` when one is there), the
card's name and power limit, and the result line.  Any mismatch raises
and exits non-zero.  Needs CUDA, nvcc and the repository's ``src/``.
"""
from __future__ import annotations

import contextlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SMALL = (200_000, 2_000_000)     # (n, powerlaw draws)
FULL = (4_847_571, 43_000_000)   # LiveJournal's node count, ~86M directed edges
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12     # 32-bit rate outside the tensor cores (same sheet)
FUSED_REPLACES = "src/repro/kernels/fused_superstep.py:202"  # _superstep_kernel
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_superstep.cu"
#: the superstep pair is also timed at the state entering this pass (a late,
#: small frontier) of the main path
LATE_PASS = 20
#: device busy-wait (cycles, ~1.2 ms at 1.7 GHz) ahead of each superstep
#: run of the per-superstep timing: the host enqueues a superstep while the
#: card waits, so its events time the card's work alone
SUPERSTEP_QUEUE_CYCLES = 2_000_000
#: runs of each superstep in the per-superstep timing (the least counts)
SUPERSTEP_RUNS = 3
#: an earlier checkout's port (``git archive <commit> src/repro_torch`` under
#: baseline/, git-ignored), whose superstep pair and segment sums are timed
#: beside the shipped ones when present
BASELINE_SRC = ROOT / "baseline" / "src"
SEGSUM_SOURCE = "src/repro_torch/kernels/csrc/segsum.cu"
SEGSUM_REPLACES = {
    "segment_sum_active": "src/repro/kernels/segsum_active.py:21",  # _kernel
    "segment_sum": "src/repro/kernels/segsum.py:25",  # _segsum_block_kernel
    # the block-activity mask that feeds segsum_active._kernel's scalar
    # prefetch (computed in jnp by make_superstep_segsum)
    "block_flags": "src/repro/kernels/ops.py:111",
}
#: substrings of the segment-sum kernels' names in a profile
SEGSUM_KERNEL_NAMES = ("segsum", "block_flags")
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores (same sheet)
BF16_OPS_PER_S = 989e12     # bf16 dense on the tensor cores (same sheet)
BAG_SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag.py:19"  # _bag_kernel
DECODE_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
DECODE_REPLACES = "src/repro/kernels/flash_decode.py:21"  # _flash_decode_kernel
#: (rtol, atol) of MIND with the kernel bag against the plain bag, float32
#: (float32 matmuls, TF32 off).  Interest vectors and retrieval scores are
#: ~1e-3 at these seeded weights; the bags differ only in summation order
#: (~1e-7 relative), ~1e-10 after the profile projection and the MLP.  The
#: same tolerance decides which top-100 neighbours are apart.
MIND_TOL = (1e-5, 1e-8)
#: absolute tolerance on Qwen3-0.6B's logits (std ~0.6), kernel attention
#: against plain attention: both round the attention output to bf16 once,
#: and a one-step difference there (2**-8 relative) can flip the bf16
#: rounding of the residual stream (|x| ~ 1, steps of 2**-7) in any of 28
#: layers
LM_LOGITS_ATOL = 0.25
LM_SLOTS, LM_MAX_LEN, LM_PROMPT, LM_GENERATE = 8, 32768, 512, 32
#: flash decode timed on bf16 caches of Qwen3-0.6B's attention, (H, Hkv, d)
#: = (16, 8, 128), as (label, B, T, cache_len): one layer of decode_32k
#: (batch cut to the served 8 slots) at the last served step, where every
#: main-path launch runs, and full; long_500k full
DECODE_HEADS = (16, 8, 128)
DECODE_SHAPES = (("served", 8, 32768, LM_PROMPT + LM_GENERATE),
                 ("decode_32k", 8, 32768, 32768),
                 ("long_500k", 1, 524288, 524288))
#: lm_prefill: serve_prefill of the prefill_32k cell (S = 32,768) on
#: Qwen3-0.6B, batch cut from 32 to 2 (the chunked form's float32
#: (S, 1,024) scores of a chunk are ~4.3 GB at B = 2), after one warm call
#: at S = 2,048; the chunked attention held on its last 1,024 query rows
PREFILL_B, PREFILL_S, PREFILL_WARM_S, PREFILL_HELD_ROWS = 2, 32768, 2048, 1024
#: the models served beyond Qwen3-0.6B: 8 slots, prompts of 64 tokens,
#: 16 greedy tokens (caches of 80 positions)
ZOO_SLOTS, ZOO_PROMPT, ZOO_GENERATE = 8, 64, 16
#: full-width depth cuts (n_layers, first_k_dense): the deepest that leave
#: room to work on 80 GB (DeepSeek-V3 ~51.9 GB of weights from 61 layers
#: cut to 3: the dense layer and 2 routed ones; Arctic ~55.4 GB from 35 to
#: 2); Qwen3-14B runs all 40 layers (~29.5 GB)
ZOO_DEPTH = {"deepseek-v3-671b": (3, 1), "arctic-480b": (2, 0)}
#: the MoE models' serve_prefill, (B, S), cut from prefill_32k's 32 x
#: 32,768: at 32k DeepSeek's 128 decompressed heads' float32 scores are
#: ~17 GB a chunk beside the ~52 GB of weights
MOE_PREFILL = (1, 4096)
#: decode against the cache-free forward, |logit difference| at most this
#: share of the cache-free logits' standard deviation.  LM_LOGITS_ATOL is
#: 0.42 of Qwen3-0.6B's logit std (~0.6); both sides round each product
#: and the attention output to bf16 once, in another order (M = 8 rows a
#: decode step against 512 a prefill), which moves a residual element by
#: one bf16 step where the rounding flips, in any layer (40 in Qwen3-14B)
ZOO_LOGITS_REL = 0.5
#: least share of (token, MoE layer) pairs that decode and the cache-free
#: form route to the same experts.  A bf16 step in the layer's input moves
#: the router logits by ~1e-3 against a spacing of ~0.2 between the k-th
#: and (k+1)-th of 256 (std ~1.7), so ~1% of DeepSeek's pairs may flip;
#: a flipped token's logits are not held to ZOO_LOGITS_REL (they take
#: another expert's output), only counted
MOE_ROUTING_AGREE = 0.9
#: flash decode also timed at the served shapes of the zoo's GQA models,
#: (label, B, T, cache_len, (H, Hkv, d)): Qwen3-14B (G = 5) and Arctic
#: (G = 7) at their caches' last step
ZOO_DECODE_SHAPES = (
    ("served_qwen3_14b", ZOO_SLOTS, ZOO_PROMPT + ZOO_GENERATE,
     ZOO_PROMPT + ZOO_GENERATE, (40, 8, 128)),
    ("served_arctic_480b", ZOO_SLOTS, ZOO_PROMPT + ZOO_GENERATE,
     ZOO_PROMPT + ZOO_GENERATE, (56, 8, 128)))
#: cache lengths the served decode reaches (1 .. 512 + 32): one position,
#: 256 and 257, the last step; held on the decode_32k cache with one below
#: and at each boundary of the kernel's split rule up to the last step
DECODE_HELD_LENS = (1, 256, 257, 544)
#: the train phase.  MIND's train_batch at full width (65,536 users), five
#: steps of AdamW at TRAIN_LR on RecsysSource batches; Qwen3-0.6B's
#: train_4k at full width with the batch cut from 256 to 8 (the 8,192-token
#: microbatch budget gives 4 microbatches of 2; 256 would take ~2 min a
#: step), three steps on batches 0, 0 (the repeated batch, whose loss must
#: fall) and 1; DeepSeek-V3 at full width cut to its dense prefix layer and
#: its MTP module (61 layers and first_k_dense 3 cut to 1; ~3.0e9
#: parameters), B x S cut from 256 x 4,096 to 1 x 4,096, int8 moments (as
#: build_step picks them for d_model >= 7000) and build_step's default
#: AdamW (lr 1e-4: at TRAIN_LR the first step moves each bf16 weight of
#: scale 0.02 by 15%), two steps; a reduced
#: Qwen3-0.6B TrainLoop crashed after TRAIN_RESUME[0] steps and resumed for
#: TRAIN_RESUME[1]
TRAIN_LR = 3e-3
TRAIN_MIND_STEPS = 5
TRAIN_LM = (8, 4096)
TRAIN_LM_BATCHES = (0, 0, 1)
TRAIN_DSV3 = (1, 4096)
TRAIN_DSV3_STEPS = 2
TRAIN_RESUME = (6, 4)
#: a train step's loss against the same batch's cache-free forward under
#: no_grad (the same bf16 products, the attention's in-place form against
#: its out-of-place one): relative; Qwen3-0.6B and DeepSeek-V3 read 0 on
#: an H100
TRAIN_LOSS_REL = 1e-6
#: the resumed TrainLoop's losses against the uninterrupted run's
#: (float32, the card's atomics reorder sums between runs): relative to
#: max(1, |loss|)
TRAIN_RESUME_TOL = 1e-5
#: the gnn phase: (run, arch, cell, the source's steps of its three train
#: steps) at full width, build_step(..., reduced=False) on make_source's
#: batches (the reference's cells, uncut), AdamW at TRAIN_LR
GNN_RUNS = (("a", "gcn-cora", "full_graph_sm", (0, 0, 0)),
            ("b", "graphsage-reddit", "minibatch_lg", (0, 1, 2)),
            ("c", "graphsage-reddit", "ogb_products", (0, 0, 0)),
            ("d", "schnet", "molecule", (0, 0, 0)),
            ("e", "egnn", "molecule", (0, 0, 0)))
#: a run's step-0 loss against the port's plain CPU run of the same cell,
#: weights and batch (float32; index_add sums with atomics on the card):
#: relative to max(1, |loss|); each gradient leaf as train_grads_hold
GNN_LOSS_REL = 1e-5
#: run c is too large for a CPU run: the logits of GNN_BALL_SEEDS rows whose
#: two-hop in-neighbourhood has at most GNN_BALL_EDGES edges, recomputed in
#: float64 on the host from the CSR, within GNN_LOGIT_REL of the largest
#: |logit| of those rows
GNN_BALL_SEEDS = 64
GNN_BALL_EDGES = 20_000
GNN_LOGIT_REL = 1e-4
#: the gnn phase's TrainLoop("gcn-cora", reduced=False): crashed after
#: GNN_RESUME[0] steps and resumed for GNN_RESUME[1]
GNN_RESUME = (6, 4)
#: run c's source (make_source of ogb_products: chung_lu of 2.45 M nodes,
#: 80.4 M directed edges, and 245 M float32 features; 126-141 s of host
#: numpy beside an H100) is drawn in a child process started before the
#: mind phase, beside the serving and train phases; the phase waits for
#: it at most this long
GNN_SOURCE_CELL = ("graphsage-reddit", "ogb_products")
GNN_SOURCE_TIMEOUT_S = 900
#: the maintain phase: edges deleted and re-inserted in the round trip
#: (and the light batch's deletes and inserts), updates of the mixed batch (deletes at repro/stream/workload.py's odds;
#: 300, not 10,000: the parallel plan of 10,000 takes ~290 s on the host,
#: and of 1,000 44-76 s a leg, which put the script near its time limit),
#: and the seed of both draws
MAINTAIN_ROUND_TRIP = 100
MAINTAIN_MIXED = 300
MAINTAIN_P_DELETE = 0.45
MAINTAIN_SEED = 19
#: the stream phase: micro-batches of one mixed draw from the main path's
#: graph (the reference bench's largest batch, repro's
#: benchmarks/bench_stream.py:44), the writer's snapshot period, the
#: seeded nodes of each query burst and the seed of both draws
STREAM_BATCHES = 6
STREAM_BATCH = 128
STREAM_SNAPSHOT_EVERY = 4
STREAM_QUERIES = 1_000
STREAM_SEED = 23
# the shard phase: shards on one card (the device list repeats cuda:0);
# the busy-wait a superstep is queued behind when timed (~5 ms: S row
# and push passes, the gather and the sums take the host up to ~1 ms)
SHARD_COUNT = 4
SHARD_QUEUE_CYCLES = 10_000_000
#: the outofcore phase's builds run in a child process of their own (its
#: peak RSS is the build's), which this script stops at this limit
OOC_BUILD_TIMEOUT_S = 600
#: the period at which :func:`sampled_rss` reads /proc/self/statm
RSS_SAMPLE_S = 0.01
#: a bf16 result against its plain version: both round one float32 result
#: to bf16 once, so an element may differ by one bf16 step of itself, which
#: is at most 2**-7 of the largest |want|.  The limit scales with what is
#: compared (decode outputs are ~N(0, 1/sqrt(cache_len)) on these inputs).
BF16_STEP = 2.0 ** -7
#: SDPA rounds its scores or weights to bf16 before the product with V, so
#: the library yardstick is held to 16 such steps
LIBRARY_STEPS = 16


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def statm() -> tuple:
    """This process's (resident, anonymous) bytes now, from
    /proc/self/statm; anonymous is resident less file-backed pages, so a
    memmap's touched pages count in the first only."""
    with open("/proc/self/statm") as f:
        resident, shared = map(int, f.read().split()[1:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page, (resident - shared) * page


@contextlib.contextmanager
def sampled_rss():
    """Sample :func:`statm` on a thread every ``RSS_SAMPLE_S`` while the
    block runs; the yielded dict gets, on exit, the start and the peak of
    each (``rss_start_bytes``, ``rss_peak_bytes``, ``anon_start_bytes``,
    ``anon_peak_bytes``).  ``ru_maxrss`` cannot stand in: it is the
    process's lifetime high-water mark (a child inherits its parent's
    across fork and exec), and the H100 machine's /proc has no VmHWM."""
    start = statm()
    peak = list(start)
    done = threading.Event()

    def sample():
        while not done.wait(RSS_SAMPLE_S):
            peak[:] = map(max, peak, statm())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    rec: dict = {}
    try:
        yield rec
    finally:
        done.set()
        sampler.join()
        peak[:] = map(max, peak, statm())
        rec.update(rss_start_bytes=start[0], rss_peak_bytes=peak[0],
                   anon_start_bytes=start[1], anon_peak_bytes=peak[1])


def same_result(a, b, what: str) -> None:
    """Every DecompResult field the port holds to the reference; a "torch"
    result ``a`` reports no kernel blocks, as the reference's "xla" does."""
    check(np.array_equal(a.core, b.core), f"{what}: core")
    check((a.cnt is None) == (b.cnt is None)
          and (a.cnt is None or np.array_equal(a.cnt, b.cnt)), f"{what}: cnt")
    fields = ["iterations", "node_computations", "updates_per_iter",
              "computations_per_iter", "edge_block_reads", "node_table_reads"]
    if a.backend == "torch":
        check(a.kernel_blocks_active == a.kernel_blocks_skipped == 0,
              f"{what}: torch reports kernel blocks")
    else:
        fields += ["kernel_blocks_active", "kernel_blocks_skipped"]
    for f in fields:
        check(getattr(a, f) == getattr(b, f), f"{what}: {f}")


def _kernel_modules() -> tuple:
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.kernels import segsum as ssk, segsum_active as ssa

    return fsk, ssk, ssa, ebk, fdk


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


@contextlib.contextmanager
def plain_serving():
    """The serving paths with each kernel's plain version in its place: the
    reference runs of the mind and lm_serve phases."""
    _, _, _, ebk, fdk = _kernel_modules()
    saved = ebk.embedding_bag, fdk.decode_attention
    ebk.embedding_bag = ebk.embedding_bag_plain
    fdk.decode_attention = fdk.decode_attention_plain
    try:
        yield
    finally:
        ebk.embedding_bag, fdk.decode_attention = saved


def launch_counts() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def powerlaw_graph(n: int, m: int, device=None):
    """The seeded powerlaw graph: ``m`` endpoint pairs drawn on the host,
    made the canonical CSR of ``CSRGraph.from_edges`` (self loops dropped,
    duplicates merged, lists sorted, by the same int64 keys ``src * n +
    dst``).  With a CUDA ``device`` the keys are sorted on the card, array
    for array the host's (the small phase holds the two equal; the
    outofcore phase holds the builder's tables to this graph)."""
    from repro_torch.graph import CSRGraph, powerlaw_chunks

    edges = np.concatenate(list(powerlaw_chunks(n=n, m=m, gamma=2.5, seed=0)))
    if device is None or device.type != "cuda":
        return CSRGraph.from_edges(n, edges)
    import torch

    e = torch.as_tensor(edges, device=device)
    del edges
    e = e[e[:, 0] != e[:, 1]]
    key = torch.unique(torch.minimum(e[:, 0], e[:, 1]) * n
                       + torch.maximum(e[:, 0], e[:, 1]))  # sorted
    del e
    lo = key // n
    hi = key - lo * n
    del key
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    del lo, hi
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(src, minlength=n), 0, out=indptr[1:])
    key = torch.sort(src * n + dst).values
    del src, dst
    adj = (key - key // n * n).to(torch.int32)
    del key
    g = CSRGraph(indptr=indptr.cpu().numpy(), adj=adj.cpu().numpy())
    torch.cuda.empty_cache()
    return g


def bound(nbytes: int, ops: int, ops_per_s: float = INT32_OPS_PER_S) -> tuple:
    """Least time on the card (ms) and what sets it: the bytes over the
    memory rate or the operations over the rate of their type (int32 by
    default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def row_bytes(n: int, edges: int) -> int:
    """Least bytes of one row pass: segptr, the active flags, core and
    cnt read once, the frontier's edges (4 B of nbr each), the two outputs
    written once, upd."""
    return 4 * (n + 1) + n + 4 * n + 4 * n + 4 * edges + 8 * n + 4


def push_bytes(n: int, edges: int) -> int:
    """Least bytes of one push pass: segptr, the flags, core and core2
    read once, the pushing rows' edges (4 B of nbr each), the target read
    and written once."""
    return 4 * (n + 1) + n + 4 * n + 4 * n + 4 * edges + 8 * n


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
          "libraries": [p.name for p in libs], "nvcc": _build.find_nvcc(),
          "ptxas": {p.name: _build.resource_usage(p) for p in libs}})


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
                    "counts"], "tolerance": 0,
          "segment_sums": parity_segsum(device),
          "embedding_bag": parity_bag(device),
          "flash_decode": parity_decode(device)})


def parity_segsum(device) -> dict:
    """The segment-sum kernels against their plain versions on seeded
    rows with rows longer than a block, empty rows and a partial last
    block."""
    import torch

    from repro_torch.kernels import segsum as ssk, segsum_active as ssa
    from repro_torch.kernels.cases import (SEGSUM_BLOCKS, SEGSUM_DTYPES,
                                           SEGSUM_FRONTIERS, SEGSUM_TOL,
                                           SEGSUM_WIDTHS, segsum_frontier,
                                           segsum_rows, segsum_values)

    def close(got, want, dtype, what):
        return _close(got, want, SEGSUM_TOL[dtype], what)

    rng = np.random.default_rng(2)
    n, checked, worst = 300, 0, {}
    for dtype in SEGSUM_DTYPES:
        for D in SEGSUM_WIDTHS:
            rows_h = segsum_rows(rng, n, 4000)
            rows = torch.as_tensor(rows_h, device=device)
            vals = torch.as_tensor(segsum_values(rng, len(rows_h), D, dtype),
                                   device=device).to(getattr(torch, dtype))
            for be in SEGSUM_BLOCKS:
                what = f"parity segment_sum {dtype} D={D} be={be}"
                err = close(ssk.segment_sum(vals, rows, n, be),
                            ssk.segment_sum_plain(vals, rows, n, be), dtype,
                            what)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                checked += 1
                for kind in SEGSUM_FRONTIERS:
                    act = torch.as_tensor(segsum_frontier(kind, rng, n),
                                          device=device)
                    flags, ids, count = ssa.active_blocks(rows, act, be)
                    check(torch.equal(flags, ssa.block_flags_plain(rows, act,
                                                                   be)),
                          f"{what} {kind}: flags")
                    check(same_list(ids, count, flags),
                          f"{what} {kind}: active-block list")
                    want = ssa.segsum_active_plain(vals, rows, flags, n, be)
                    for blocks in (None, (ids, count)):
                        err = close(
                            ssa.segsum_active(vals, rows, flags, n, be,
                                              blocks=blocks),
                            want, dtype, f"{what} {kind}: segment_sum_active")
                        worst[dtype] = max(worst[dtype], err)
                    checked += 4
    torch.cuda.synchronize(device)
    return {"checks": checked, "dtypes": list(SEGSUM_DTYPES),
            "widths": list(SEGSUM_WIDTHS), "block_edges": list(SEGSUM_BLOCKS),
            "frontiers": list(SEGSUM_FRONTIERS), "max_abs_err": worst,
            "tolerance": {k: list(v) for k, v in SEGSUM_TOL.items()}}


def same_list(ids, count, flags) -> bool:
    """The kernel's active-block list (any order) holds the flagged blocks'
    ids, as the plain version lists them."""
    import torch

    from repro_torch.kernels import segsum_active as ssa

    want_ids, want_count = ssa.block_list_plain(flags)
    c = int(count.item())
    return c == int(want_count.item()) and torch.equal(
        torch.sort(ids[:c]).values, want_ids[:c])


def _close(got, want, tol, what) -> float:
    """Max |got - want|, checked against ``atol + rtol * |want|``."""
    rtol, atol = tol
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape")
    err = (got.float() - want.float()).abs()
    check(bool((err <= atol + rtol * want.float().abs()).all()), what)
    return float(err.max()) if err.numel() else 0.0


def bf16_hold(got, want, steps: float = 1.0) -> tuple:
    """(max |got - want|, limit) with the limit ``steps`` bf16 steps of
    the largest |want| (:data:`BF16_STEP`)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          "bf16 hold: dtype/shape")
    err = float((got.float() - want.float()).abs().max())
    return err, steps * BF16_STEP * float(want.float().abs().max())


def hold_decode(q, k, v, n: int, what: str) -> dict:
    """bf16 ``decode_attention`` against its plain version at cache_len
    ``n``, to :func:`bf16_hold`'s limit, and that limit tried on the
    planted faults it must reject: the last split below ``n`` dropped and,
    where there are at least three splits, a middle one dropped (the plain
    split's partials with that split's l and acc zeroed, then the plain
    combine), the score scale doubled (q * 2), and an all-zero output.  At
    n = 1 the scale changes nothing (one weight of 1), so there it is only
    reported."""
    import torch

    from repro_torch.kernels import flash_decode as fdk

    B, T, Hkv = k.shape[:3]
    G = q.shape[1] // Hkv
    lens = torch.tensor(n, dtype=torch.int32, device=q.device)
    want = fdk.decode_attention_plain(q, k, v, lens)
    err, lim = bf16_hold(fdk.decode_attention(q, k, v, lens), want)
    check(err <= lim, f"{what} cache_len={n}: error {err} > limit {lim}")
    ns = fdk.split_plan(n, T, B, Hkv, G)[2]
    ml, acc = fdk.split_plain(q, k, v, lens)

    def dropped(s):
        ml_, acc_ = ml.clone(), acc.clone()
        ml_[:, :, s, :, 1] = 0
        acc_[:, :, s] = 0
        return fdk.combine_plain(ml_, acc_, lens, T, q.dtype)

    planted = {"last_split_dropped": dropped(ns - 1),
               "scale_doubled": fdk.decode_attention_plain(q * 2, k, v, lens),
               "zeros": torch.zeros_like(want)}
    if ns >= 3:
        planted["middle_split_dropped"] = dropped(ns // 2)
    planted_err = {}
    for name, bad in planted.items():
        planted_err[name] = bf16_hold(bad, want)[0]
        if not (name == "scale_doubled" and n == 1):
            check(planted_err[name] > lim, f"{what} cache_len={n}: the limit "
                  f"{lim} does not reject the planted fault {name}")
    return {"cache_len": n, "splits": ns, "max_abs_err": err, "limit": lim,
            "planted_err": planted_err}


def parity_bag(device) -> dict:
    """The embedding-bag kernel against its plain version over the
    reference's sweep, sum and mean, float32 and bfloat16, with and
    without weights, a quarter of the slots masked."""
    import torch

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels.cases import (BAG_CASES, BAG_DTYPES, BAG_MODES,
                                           BAG_TOL, bag_case)

    rng = np.random.default_rng(3)
    checked, worst = 0, {}
    for (N, D, B, L) in BAG_CASES:
        table, idx, w = (torch.as_tensor(a, device=device)
                         for a in bag_case(rng, N, D, B, L))
        for dtype in BAG_DTYPES:
            t = table.to(getattr(torch, dtype))
            for mode in BAG_MODES:
                for weights in (w, None):
                    what = f"parity embedding_bag {dtype} {mode} N={N} D={D}" \
                        f" B={B} L={L} weights={weights is not None}"
                    err = _close(ebk.embedding_bag(t, idx, weights, mode=mode),
                                 ebk.embedding_bag_plain(t, idx, weights,
                                                         mode=mode),
                                 BAG_TOL[dtype], what)
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    checked += 1
    torch.cuda.synchronize(device)
    return {"checks": checked, "max_abs_err": worst,
            "tolerance": {k: list(v) for k, v in BAG_TOL.items()}}


def parity_decode(device) -> dict:
    """The flash-decode kernels against their plain versions over the
    reference's sweep at the model layout, at every boundary of the split
    rule, at cache_len <= 0 and past T (and one case at the TPU layout):
    the whole function, and the split and combine kernels each on the same
    inputs."""
    import torch

    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels.ref import flash_decode_ref
    from repro_torch.kernels.cases import (DECODE_BATCH, DECODE_CASES,
                                           DECODE_DTYPES, DECODE_TOL,
                                           decode_case, decode_lens)

    rng = np.random.default_rng(4)
    checked, worst = 0, {}
    for (Hkv, G, S, d) in DECODE_CASES:
        q, k, v = (torch.as_tensor(a, device=device) for a in
                   decode_case(rng, DECODE_BATCH, Hkv, G, S, d))
        for dtype in DECODE_DTYPES:
            dt = getattr(torch, dtype)
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            tol = DECODE_TOL[dtype]
            for n in decode_lens(S, fdk.split_boundaries(
                    S, DECODE_BATCH, Hkv, G)) + (0, -3, S + 5):
                what = f"parity flash_decode {dtype} Hkv={Hkv} G={G} S={S} " \
                    f"d={d} len={n}"
                lens = torch.tensor(n, dtype=torch.int32, device=device)
                got = fdk.decode_attention(qd, kd, vd, lens)
                want = fdk.decode_attention_plain(qd, kd, vd, lens)
                err = _close(got, want, tol, what)
                if dt == torch.bfloat16:  # and to the scaled bf16 limit
                    e, lim = bf16_hold(got, want)
                    check(e <= lim, f"{what}: error {e} > limit {lim}")
                # each kernel alone: the split on the splits the rule gives
                # len, the combine on the kernel's own partials
                ml, acc = fdk.launch_split(qd, kd, vd, lens)
                ml_p, acc_p = fdk.split_plain(qd, kd, vd, lens)
                ns = fdk.split_plan(n, S, DECODE_BATCH, Hkv, G)[2]
                _close(ml[:, :, :ns], ml_p[:, :, :ns], (2e-4, 2e-4),
                       f"{what}: split m, l")
                _close(acc[:, :, :ns], acc_p[:, :, :ns], (2e-4, 2e-4),
                       f"{what}: split acc")
                _close(fdk.launch_combine(ml, acc, lens, S, dt),
                       fdk.combine_plain(ml, acc, lens, S, dt), tol,
                       f"{what}: combine")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                checked += 3
        # the TPU kernel's layout, (H, d) and (Hkv, S, d), on strided views
        kt, vt = k[0].permute(1, 0, 2), v[0].permute(1, 0, 2)
        _close(fdk.flash_decode(q[0], kt, vt, S - 17),
               flash_decode_ref(q[0], kt, vt, S - 17),
               DECODE_TOL["float32"], f"parity flash_decode (H, d) S={S}")
        checked += 1
    torch.cuda.synchronize(device)
    return {"checks": checked, "max_abs_err": worst,
            "tolerance": {k: list(v) for k, v in DECODE_TOL.items()},
            "bfloat16_limit": "also 2**-7 * max|want|",
            "split_tolerance": [2e-4, 2e-4]}


def other_substrates(device, run, ref, what: str) -> dict:
    """``run(backend)`` per probe and on "torch", each held to ``ref``;
    returns walls and the per-probe kernels' launches."""
    import torch

    from repro_torch.core import CudaBackend, TorchBackend

    out = {}
    for label, backend in (("per_probe", CudaBackend(device=device,
                                                     fused=False)),
                           ("torch", TorchBackend(device=device))):
        reset_launch_counts()
        t = time.perf_counter()
        r = run(backend)
        torch.cuda.synchronize(device)
        out[f"{label}_wall_s"] = time.perf_counter() - t
        same_result(r, ref, f"{what} {label}")
        launches = launch_counts()
        if label == "per_probe":
            for name in ("block_flags", "segment_sum_active"):
                check(launches[name] > 0, f"{what}: {name} never launched")
            out["per_probe_launches"] = {
                k: launches[k] for k in ("block_flags", "segment_sum_active")}
        else:
            check(not any(launches.values()),
                  f"{what}: torch launched a kernel of the port")
    return out


def phase_small(device, n: int, m: int) -> tuple:
    """The small graph on every substrate; returns (the graph, its
    semicore* result on "cuda")."""
    import torch

    from repro_torch.core import CudaBackend, HostEngine, decompose, warm_settle
    from repro_torch.core.imcore import imcore_peel
    from repro_torch.graph import BufferedGraph

    t0 = time.perf_counter()
    g = powerlaw_graph(n, m, device)
    gen_s = time.perf_counter() - t0
    gh = powerlaw_graph(n, m)
    check(np.array_equal(g.indptr, gh.indptr) and np.array_equal(g.adj, gh.adj),
          "small: the graph made on the card != CSRGraph.from_edges'")
    del gh
    expect = imcore_peel(g)
    out = {"phase": "small", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "kmax": int(expect.max()),
           "host_build_s": gen_s, "runs": {}}
    star = None
    for algo in ("semicore", "semicore+", "semicore*"):
        reset_launch_counts()
        t = time.perf_counter()
        r = decompose(g, algo, backend=CudaBackend(device=device))
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        launches = {k: v for k, v in launch_counts().items() if v}
        check(launches.get("row_pass", 0) > 0,
              f"{algo}: row_pass never launched")
        if algo != "semicore":
            check(launches.get("push_pass", 0) > 0,
                  f"{algo}: push_pass never launched")
        rp = decompose(g, algo, backend=CudaBackend(device=device, plain=True))
        same_result(r, rp, f"small {algo}")
        check(np.array_equal(r.core, expect), f"small {algo}: core != peel")
        out["runs"][algo] = {"passes": r.iterations, "wall_s": wall,
                             "launches": launches,
                             **other_substrates(
                                 device, lambda b: decompose(g, algo,
                                                             backend=b),
                                 r, f"small {algo}")}
        star = r if algo == "semicore*" else star
    # warm settle after edge deletions and insertions
    rng = np.random.default_rng(1)
    bg = BufferedGraph(g)
    edges = g.edge_list()
    for i in rng.choice(len(edges), size=200, replace=False):
        bg.delete_edge(*map(int, edges[i]))
    inserted = sum(bg.insert_edge(int(u), int(v))
                   for u, v in rng.integers(0, g.n, size=(200, 2)))
    reset_launch_counts()
    rw = warm_settle(HostEngine(bg), star.core, inserted,
                     CudaBackend(device=device))
    launches = {k: v for k, v in launch_counts().items() if v}
    rwp = warm_settle(HostEngine(bg), star.core, inserted,
                      CudaBackend(device=device, plain=True))
    same_result(rw, rwp, "small warm_settle")
    check(launches.get("row_pass", 0) > 0,
          "warm_settle: row_pass never launched")
    out["runs"]["warm_settle"] = {
        "passes": rw.iterations, "inserted": inserted, "launches": launches,
        **other_substrates(
            device, lambda b: warm_settle(HostEngine(bg), star.core,
                                          inserted, b),
            rw, "small warm_settle")}
    out["runs"]["maintain"] = small_maintain(device, g, star)
    out["emcore"] = small_emcore(g, star, expect)
    # last: materialize() flushes the buffer, which rewrites the base CSR
    # (and so the block layout every later engine would charge)
    check(np.array_equal(rw.core, imcore_peel(bg.materialize())),
          "small warm_settle: core != peel")
    emit(out)
    return g, star


def small_emcore(g, star, expect) -> dict:
    """EMCore, the external-memory baseline (Algorithm 2), on the small
    graph at its default partitions and memory budget: its core equal to
    imcore_peel, and its rounds, block reads and writes and peak memory
    beside semicore*'s edge block reads and node-state bytes (the paper's
    Fig. 9 comparison at this size)."""
    from repro_torch.core import emcore

    t = time.perf_counter()
    em = emcore(g)
    wall = time.perf_counter() - t
    check(np.array_equal(em.core, expect), "emcore: core != peel")
    return {"wall_s": wall, "rounds": em.rounds,
            "read_blocks": em.read_blocks, "write_blocks": em.write_blocks,
            "peak_memory_edges": em.peak_memory_edges,
            "peak_memory_bytes": em.peak_memory_bytes,
            "over_budget_rounds": em.over_budget_rounds,
            "semicore_star": {"edge_block_reads": star.edge_block_reads,
                              "node_table_reads": star.node_table_reads,
                              "memory_bytes": star.memory_bytes}}


def small_maintain(device, g, star) -> dict:
    """The seven update families through ``CoreMaintainer.apply`` from
    ``star``'s state on every substrate of the port, each leg's (core, cnt)
    after every family equal to the numpy per-edge oracle's (Algs. 6-8,
    SemiInsert* and SemiInsert alike) bit for bit.  The fused kernels must
    launch on the "cuda" leg and the segment sums on the per-probe leg;
    the plain version and "torch" launch none."""
    import torch

    from repro_torch.core import CoreMaintainer, CudaBackend, UpdateBatch
    from repro_torch.graph import BufferedGraph
    from repro_torch.graph.update_cases import families
    from repro_torch.runtime import Settings

    state = (star.core, star.cnt)
    legs = {"cuda": lambda: "cuda",
            "per_probe": lambda: CudaBackend(device=device, fused=False),
            "torch": lambda: "torch",
            "plain": lambda: CudaBackend(device=device, plain=True)}
    out = {"families": {}, "legs": {k: {"wall_s": 0.0, "launches": {}}
                                    for k in legs}}
    for name, batches in families(g, star.core).items():
        batches = [UpdateBatch.from_wire(b) for b in batches]
        rec = {"ops": sum(len(b) for b in batches)}
        want = None
        for algo in ("semiinsert*", "semiinsert"):
            t = time.perf_counter()
            oracle = CoreMaintainer(BufferedGraph(g), state=state,
                                    settings=Settings(backend="numpy",
                                                      parallel_maint=False))
            for b in batches:
                oracle.apply(b, insert_algorithm=algo)
            rec[f"oracle_{algo}_s"] = time.perf_counter() - t
            got = (oracle.core, oracle.cnt)
            check(want is None or all(np.array_equal(x, y)
                                      for x, y in zip(got, want)),
                  f"maintain {name}: SemiInsert != SemiInsert*")
            want = got
        for label, make in legs.items():
            reset_launch_counts()
            t = time.perf_counter()
            m = CoreMaintainer(BufferedGraph(g), state=state, backend=make(),
                               device=device)
            stats = [m.apply(b) for b in batches]
            torch.cuda.synchronize(device)
            leg = out["legs"][label]
            leg["wall_s"] += time.perf_counter() - t
            for k, v in launch_counts().items():
                if v:
                    leg["launches"][k] = leg["launches"].get(k, 0) + v
            check(np.array_equal(m.core, want[0])
                  and np.array_equal(m.cnt, want[1]),
                  f"maintain {name} on {label} != the per-edge oracle")
            rec[label] = {k: sum(getattr(s_, k) for s_ in stats)
                          for k in ("groups", "fallbacks", "settle_passes",
                                    "num_changed")}
        out["families"][name] = rec
    fused = out["legs"]["cuda"]["launches"]
    probe = out["legs"]["per_probe"]["launches"]
    for name in ("row_pass", "push_pass"):
        check(fused.get(name, 0) > 0, f"maintain: {name} never launched")
    for name in ("block_flags", "segment_sum_active"):
        check(probe.get(name, 0) > 0,
              f"maintain per probe: {name} never launched")
    for label in ("torch", "plain"):
        check(not out["legs"][label]["launches"],
              f"maintain: {label} launched a kernel of the port")
    return out


def phase_full(device, g, gen_s: float) -> dict:
    """The main path at full width: returns the fused kernels' launches on
    it (``launches``), its result (``result``), the device ms of all its
    supersteps by both clocks and their bound, and the state entering pass
    ``LATE_PASS`` (``late``)."""
    import torch

    from repro_torch.core import CudaBackend, decompose
    from repro_torch.obs import trace

    out = {"phase": "full", "n": g.n, "directed_edges": g.num_directed,
           "dmax": int(g.degrees().max()), "host_build_s": gen_s}

    t = time.perf_counter()
    decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["cold_wall_s"] = time.perf_counter() - t

    # the main path: launch counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t = time.perf_counter()
    r = decompose(g, "semicore*", backend=CudaBackend(device=device))
    torch.cuda.synchronize(device)
    out["warm_wall_s"] = time.perf_counter() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    out["launches"] = launches
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["passes"] = r.iterations
    out["kmax"] = r.kmax
    for name in ("row_pass", "push_pass"):
        check(launches.get(name, 0) > 0, f"main path: {name} never launched")

    # device time of every superstep (row pass + push pass + frontier ops)
    be = CudaBackend(device=device)
    events = time_supersteps(be)
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

    # each superstep alone on the card, its frontier and its bound
    rq, passes, late = per_superstep(device, g)
    same_result(rq, r, "full per-superstep rerun")
    out["per_superstep"] = {k: [p[k] for p in passes] for k in passes[0]}
    out["superstep_device_ms_total"] = sum(p["device_ms"] for p in passes)
    out["superstep_bound_ms_total"] = sum(p["bound_ms"] for p in passes)

    t = time.perf_counter()
    rp = decompose(g, "semicore*", backend=CudaBackend(device=device,
                                                       plain=True))
    torch.cuda.synchronize(device)
    out["plain_wall_s"] = time.perf_counter() - t
    same_result(r, rp, "full semicore*")
    emit(out)
    return {"launches": launches, "result": r,
            "superstep_ms": out["superstep_ms_total"],
            "superstep_device_ms": out["superstep_device_ms_total"],
            "superstep_bound_ms": out["superstep_bound_ms_total"],
            "late": late}


def timed_superstep(step, args, kw) -> tuple:
    """``step(*args, **kw)`` run ``SUPERSTEP_RUNS`` times on the same
    inputs (a superstep writes only new tensors), each run queued behind a
    device busy-wait (``SUPERSTEP_QUEUE_CYCLES``) so that its CUDA events
    time its kernels alone; returns (the last run's result, the event pairs).
    The least of the runs is the device time: a host stall longer than the
    busy-wait lengthens one run, not all."""
    import torch

    pairs = []
    for _ in range(SUPERSTEP_RUNS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SUPERSTEP_QUEUE_CYCLES)
        s.record()
        res = step(*args, **kw)
        e.record()
        pairs.append((s, e))
    return res, pairs


def per_superstep(device, g) -> tuple:
    """The main path once more, each superstep timed alone on the card
    (:func:`timed_superstep`).  Returns (the result, per superstep its
    device ms, its frontier's rows and edges, the rows whose core changed
    and their edges, and the bound of ``row_pass`` + ``push_pass`` on
    them, the state entering pass ``LATE_PASS``)."""
    import torch

    from repro_torch.core import CudaBackend, decompose

    be = CudaBackend(device=device)
    deg = torch.as_tensor(g.degrees(), device=device)
    rec, late = [], {}
    resident_ops = be.resident_ops

    def ops(*a):
        step, counts = resident_ops(*a)

        def timed(core, cnt, active, segptr, nbr, **kw):
            if len(rec) == LATE_PASS:
                late.update(core=core.clone(), cnt=cnt.clone(),
                            active=active.clone())
            res, pairs = timed_superstep(
                step, (core, cnt, active, segptr, nbr), kw)
            pushing = active & (res[0] != core)
            rec.append((pairs, torch.stack([
                active.sum(), (deg * active).sum(), pushing.sum(),
                (deg * pushing).sum()])))
            return res

        return timed, counts

    be.resident_ops = ops
    r = decompose(g, "semicore*", backend=be)
    torch.cuda.synchronize(device)
    stats = torch.stack([x[1] for x in rec]).cpu().numpy()
    passes = []
    for (pairs, _), (rows, edges, prows, pedges) in zip(rec, stats):
        bms, _ = bound(row_bytes(g.n, int(edges)) + push_bytes(g.n, int(pedges)),
                       int(edges + pedges))
        passes.append({"device_ms": min(s.elapsed_time(e) for s, e in pairs),
                       "frontier_rows": int(rows),
                       "frontier_edges": int(edges),
                       "push_rows": int(prows), "push_edges": int(pedges),
                       "bound_ms": bms})
    check(len(passes) > LATE_PASS and late,
          f"the main path ran no pass {LATE_PASS}")
    return r, passes, late


def time_supersteps(backend) -> list:
    """Wrap the backend's resident superstep in CUDA events; returns the
    list that collects one (start, end) pair per superstep."""
    import torch

    events = []
    resident_ops = backend.resident_ops

    def timed_ops(*a):
        step, counts = resident_ops(*a)

        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = step(*args, **kw)
            e.record()
            events.append((s, e))
            return res

        return timed, counts

    backend.resident_ops = timed_ops
    return events


def phase_per_probe(device, g, ref) -> dict:
    """The same decompose per probe (the segment-sum kernels' path) and on
    "torch", each held to the fused result; the block-read counter against
    the paper's block discipline.  Returns the per-probe path's launches."""
    import torch

    from repro_torch.core import CudaBackend, TorchBackend, decompose
    from repro_torch.kernels import segsum as ssk

    # every pass launches num_probes h-index probes and one count over the
    # same flags; num_probes covers the largest initial core bound, dmax
    dmax = int(g.degrees().max())
    num_probes = max(1, int(np.ceil(np.log2(dmax + 2))))
    out = {"phase": "per_probe", "num_probes": num_probes, "runs": {}}
    launches = None
    for label, backend in (("per_probe", CudaBackend(device=device,
                                                     fused=False)),
                           ("torch", TorchBackend(device=device))):
        events = time_supersteps(backend)
        torch.cuda.reset_peak_memory_stats(device)
        ssk.reset_blocks_read()
        # this path's launch counts: set to 0 just before, read just after
        reset_launch_counts()
        t = time.perf_counter()
        r = decompose(g, "semicore*", backend=backend)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        run_launches = {k: v for k, v in launch_counts().items() if v}
        same_result(r, ref, f"full {label}")
        per_pass = [s.elapsed_time(e) for s, e in events]
        run = {"wall_s": wall, "passes": r.iterations,
               "launches": run_launches,
               "max_memory_allocated":
                   torch.cuda.max_memory_allocated(device),
               "superstep_ms_total": sum(per_pass),
               "supersteps_launched": len(per_pass),
               "superstep_ms_first": per_pass[0]}
        if label == "per_probe":
            launches = run_launches
            for name in ("block_flags", "segment_sum_active"):
                check(launches.get(name, 0) > 0,
                      f"per-probe path: {name} never launched")
            read = ssk.blocks_read(device)
            want = (num_probes + 1) * r.kernel_blocks_active
            check(read == want, f"blocks read {read} != (num_probes + 1) x "
                  f"kernel_blocks_active = {want}")
            run.update(blocks_read=read,
                       kernel_blocks_active=r.kernel_blocks_active,
                       kernel_blocks_skipped=r.kernel_blocks_skipped)
            # the same decompose under the profiler: its device time split
            # between the segment-sum kernels and the rest (the torch glue
            # of each probe, the structure's upload)
            run["device_profile"] = device_profile(
                lambda: decompose(g, "semicore*", backend=CudaBackend(
                    device=device, fused=False)), top=8,
                groups={"segment_sum_kernels": SEGSUM_KERNEL_NAMES})
        else:
            check(not run_launches, "torch launched a kernel of the port")
        out["runs"][label] = run
    emit(out)
    return launches


def ooc_build_child(out_dir: str, relabel: str, n: str, m: str) -> int:
    """``python3 chip_smoke.py --ooc-build-child OUT_DIR RELABEL N DRAWS``:
    ``build_csr`` of the powerlaw stream of that shape at the default
    chunk_edges into ``out_dir``, in a process of its own so that its
    sampled peak RSS is the build's.  Prints its BuildStats, wall and RSS
    as one JSON line; saves perm beside ``out_dir``."""
    from repro_torch.graph import build_csr, powerlaw_chunks

    n, m = int(n), int(m)
    with sampled_rss() as rss:
        t = time.perf_counter()
        stats = build_csr(powerlaw_chunks(n=n, m=m, gamma=2.5, seed=0),
                          out_dir, n=n, relabel=relabel)
        wall = time.perf_counter() - t
    if stats.perm is not None:
        np.save(out_dir + ".perm.npy", stats.perm)
    emit({"wall_s": wall, **stats.to_json(), **rss})
    return 0


def gnn_source_child(out_dir: str, arch: str, shape: str) -> int:
    """``python3 chip_smoke.py --gnn-source-child OUT_DIR ARCH CELL``:
    ``make_source`` of that full-width cell; its step-0 batch and its graph
    saved as ``.npy`` files under ``out_dir``.  Prints the draw's and the
    save's walls as one JSON line."""
    from repro_torch.configs import get_config
    from repro_torch.train import make_source

    t = time.perf_counter()
    src = make_source(get_config(arch), shape, False)
    batch = src(0)
    source_s = time.perf_counter() - t
    t = time.perf_counter()
    arrays = {**{f"batch.{k}": v for k, v in batch.items()},
              "indptr": src.graph.indptr, "adj": src.graph.adj}
    for name, a in arrays.items():
        np.save(os.path.join(out_dir, name + ".npy"), a)
    emit({"source_s": source_s, "save_s": time.perf_counter() - t,
          "keys": sorted(batch)})
    return 0


class ChildSource:
    """A full-width GNN cell's source drawn by :func:`gnn_source_child` in
    a process of its own, started here; :meth:`result` waits for it and
    loads what it saved, :meth:`close` (or leaving a ``with`` block) stops
    it and removes its files."""

    def __init__(self, arch: str, shape: str):
        self.cell = (arch, shape)
        self.tmp = tempfile.TemporaryDirectory(prefix="gnn_source_")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--gnn-source-child", self.tmp.name, arch, shape],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> tuple:
        """``(graph, step-0 batch, record)``: the record has the child's
        draw and save walls, the parent's wait and load seconds."""
        from repro_torch.graph import CSRGraph

        t = time.perf_counter()
        out, err = self.proc.communicate(timeout=GNN_SOURCE_TIMEOUT_S)
        wait_s = time.perf_counter() - t
        check(self.proc.returncode == 0,
              f"gnn source {self.cell} failed: {err[-4000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        t = time.perf_counter()

        def load(name):
            return np.load(os.path.join(self.tmp.name, name + ".npy"))

        batch = {k: load(f"batch.{k}") for k in rec.pop("keys")}
        graph = CSRGraph(indptr=load("indptr"), adj=load("adj"))
        rec.update({"child_wall_s": time.perf_counter() - self.t0,
                    "wait_s": wait_s, "load_s": time.perf_counter() - t})
        return graph, batch, rec

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_out_of_core(out_dir: str, relabel: str, shape: tuple) -> dict:
    """``build_csr`` of the powerlaw stream of ``shape`` (n, draws) into
    ``out_dir`` in a child process (:func:`ooc_build_child`); returns its
    JSON record."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--ooc-build-child",
         out_dir, relabel, str(shape[0]), str(shape[1])],
        capture_output=True, text=True, timeout=OOC_BUILD_TIMEOUT_S)
    check(proc.returncode == 0,
          f"out-of-core build ({relabel}) failed: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def hold_relabeled(g2, g, perm) -> None:
    """``g2`` is ``g`` with node v renamed ``perm[v]``: equal degrees
    through perm, and the same sorted (src, dst) keys once ``g``'s are
    renamed (each CSR row is sorted, so ``g2``'s keys are sorted already)."""
    check(g2.n == g.n and g2.num_directed == g.num_directed,
          "relabeled build: n or 2m differs")
    deg = g.degrees()
    check(np.array_equal(g2.degrees()[perm], deg),
          "relabeled build: degrees differ through perm")
    check(np.all(np.diff(g2.degrees()) <= 0),
          "relabeled build: ids are not degree-descending")
    n64 = np.int64(g.n)
    want = perm[np.repeat(np.arange(g.n, dtype=np.int64), deg)] * n64
    want += perm[np.asarray(g.adj)]
    want.sort()
    got = np.repeat(np.arange(g.n, dtype=np.int64), g2.degrees()) * n64
    got += np.asarray(g2.adj)
    check(np.array_equal(got, want),
          "relabeled build: edges differ from the graph's through perm")


def phase_outofcore(device, g, r, small) -> dict:
    """The semi-external path: the full phase's stream built out of core
    into on-disk tables (``build_csr`` at the default chunk, in a child
    process), memmap-loaded and held array-equal to the in-memory graph
    ``g``, decomposed on the card with every DecompResult field equal to
    the main path's ``r``; then the ``relabel="degree"`` build of the small
    phase's stream (``small``: its graph and semicore* result), held to
    them through perm (equal passes and updates per pass).  The relabeled
    build runs at the small shape because at full width it took 259 s of
    host time on the H100 machine (PERF.md), past this script's budget.
    Each decompose starts from a fresh load (no table page mapped yet) and
    reports this process's resident and anonymous memory at its start and
    peak (:func:`sampled_rss`).  Each decompose, and the decompose of the
    graph the relabel renames, is run once more with every superstep timed
    alone (:func:`per_superstep`): the node-order lever on the first
    superstep.  Returns the kernels' launches over the two decomposes."""
    import torch

    from repro_torch.core import CudaBackend, decompose
    from repro_torch.graph import CSRGraph
    from repro_torch.obs import trace

    legs = (("plain", "none", FULL, g, r), ("degree", "degree", SMALL, *small))
    out = {"phase": "outofcore", "n": g.n, "directed_edges": g.num_directed,
           "relabeled_n": small[0].n,
           "relabeled_directed_edges": small[0].num_directed,
           "builds": {}, "decomposes": {}}
    total: dict = {}
    with tempfile.TemporaryDirectory(prefix="ooc_") as work:
        for label, relabel, shape, base, base_r in legs:
            path = os.path.join(work, label)
            rec = build_out_of_core(path, relabel, shape)
            t = time.perf_counter()
            go = CSRGraph.load(path, mmap=True)
            check(isinstance(go.adj, np.memmap),
                  f"outofcore {label}: adj is not memmapped")
            perm = None
            if relabel == "none":
                check(np.array_equal(go.indptr, base.indptr)
                      and np.array_equal(go.adj, base.adj),
                      "outofcore: the memmapped graph != the in-memory one")
            else:
                perm = np.load(path + ".perm.npy")
                hold_relabeled(go, base, perm)
            rec["hold_s"] = time.perf_counter() - t
            out["builds"][label] = rec
            # the hold mapped every table page: unmap them, then load anew
            del go
            go = CSRGraph.load(path, mmap=True)

            # the decompose: counts set to 0 just before, read just after
            reset_launch_counts()
            trace.clear_trace()
            trace.start_trace()
            with sampled_rss() as rss:
                t = time.perf_counter()
                ro = decompose(go, "semicore*",
                               backend=CudaBackend(device=device))
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t
            trace.stop_trace()
            launches = {k: v for k, v in launch_counts().items() if v}
            for name in ("row_pass", "push_pass"):
                check(launches.get(name, 0) > 0,
                      f"outofcore {label}: {name} never launched")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            spans = trace.get_collector().to_chrome()["traceEvents"]
            if perm is None:
                same_result(ro, base_r, "outofcore decompose")
            else:
                check(np.array_equal(ro.core[perm], base_r.core)
                      and np.array_equal(ro.cnt[perm], base_r.cnt),
                      "outofcore relabeled: core or cnt differ through perm")
                for f in ("iterations", "updates_per_iter",
                          "computations_per_iter", "node_computations"):
                    check(getattr(ro, f) == getattr(base_r, f),
                          f"outofcore relabeled: {f}")
            rq, passes, _ = per_superstep(device, go)
            same_result(rq, ro, f"outofcore {label} per-superstep rerun")
            dec = out["decomposes"][label] = {
                "wall_s": wall,
                "structure_s": sum(
                    e["dur"] for e in spans
                    if e["name"] == "resident.structure"
                    and e.get("ph") == "X") / 1e6,
                "passes": ro.iterations, "launches": launches,
                "edge_block_reads": ro.edge_block_reads,
                "node_table_reads": ro.node_table_reads,
                "kernel_blocks_active": ro.kernel_blocks_active,
                "first_superstep_device_ms": passes[0]["device_ms"],
                "first_superstep_bound_ms": passes[0]["bound_ms"],
                "superstep_device_ms_total": sum(p["device_ms"]
                                                 for p in passes),
                "host_memory": rss}
            if perm is not None:
                # the graph the relabel renames, by the same clock
                _, base_passes, _ = per_superstep(device, base)
                dec["without_relabel"] = {
                    "edge_block_reads": base_r.edge_block_reads,
                    "node_table_reads": base_r.node_table_reads,
                    "kernel_blocks_active": base_r.kernel_blocks_active,
                    "first_superstep_device_ms":
                        base_passes[0]["device_ms"],
                    "superstep_device_ms_total": sum(
                        p["device_ms"] for p in base_passes)}
            del go, ro, rq
    emit(out)
    return total


def timed_apply(device, m, batch, events: list) -> tuple:
    """``m.apply(batch)`` traced: returns (its MaintStats, its record: the
    wall, the host split by span, supersteps and their device ms by CUDA
    events (``events``, from :func:`time_supersteps` on ``m.backend``),
    rounds, groups, fallbacks and escalations, block reads, structure
    builds, launches, peak device memory and the process's peak RSS)."""
    import torch

    from repro_torch.obs import metrics, trace

    reg = metrics.get_registry()
    snap = reg.snapshot()
    builds = m.backend.structure_builds
    events.clear()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    trace.clear_trace()
    trace.start_trace()
    t = time.perf_counter()
    s = m.apply(batch)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    trace.stop_trace()
    spans = trace.get_collector().to_chrome()["traceEvents"]
    d = reg.delta(snap)

    def span_s(name):
        return sum(e["dur"] for e in spans
                   if e["name"] == name and e.get("ph") == "X") / 1e6

    structure = span_s("resident.structure")
    return s, {
        "wall_s": wall, "algorithm": s.algorithm, "path": settle_path(s),
        "host_split_s": {
            "structural_apply": span_s("maintenance.structural"),
            "arrays_plan_peel": span_s("maintenance.plan"),
            "structure_rebuild_upload": structure,
            "device_settle": span_s("maintenance.settle") - structure},
        "deletes": s.num_deletes, "inserts": s.num_inserts,
        "noops": s.num_noops, "num_changed": s.num_changed,
        "supersteps": s.iterations,
        "rounds": int(metrics.sum_by_name(
            d, "repro_maintenance_settle_rounds_sum")),
        "groups": s.groups, "largest_group": s.largest_group,
        "fallbacks": s.fallbacks,
        "escalations": int(metrics.sum_by_name(
            d, "repro_maintenance_escalations_total")),
        "edge_block_reads": s.edge_block_reads,
        "node_table_reads": s.node_table_reads,
        "superstep_device_ms": sum(a.elapsed_time(b) for a, b in events),
        "supersteps_launched": len(events),
        "structure_builds": m.backend.structure_builds - builds,
        "launches": {k: v for k, v in launch_counts().items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "host_peak_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def settle_path(s) -> str:
    """Which settle an apply ran, from its MaintStats: "warm_settle" (the
    serial path), "fallback" (the grouped settle sent a round to
    warm_settle), "masked" (every round in the masked fixpoint) or
    "none" (nothing to settle)."""
    if s.algorithm.startswith("batch-settle"):
        return "warm_settle"
    if s.fallbacks:
        return "fallback"
    return "masked" if s.iterations else "none"


def mixed_legs(device) -> dict:
    """The maintainer arguments of a batch's three paths: the grouped
    settle on "cuda", the serial one (one warm_settle) on "cuda", the
    grouped settle per probe."""
    from repro_torch.core import CudaBackend
    from repro_torch.runtime import Settings

    return {"parallel_cuda": lambda: {},
            "serial_cuda": lambda: {"settings": Settings(
                backend="cuda", parallel_maint=False)},
            "parallel_per_probe": lambda: {"backend": CudaBackend(
                device=device, fused=False)}}


def apply_legs(device, g, r, batch, legs, what="mixed batch") -> dict:
    """``batch`` applied from ``r``'s state on a fresh maintainer for each
    of ``legs`` (names of :func:`mixed_legs`), every (core, cnt) equal to
    the first's; returns each leg's :func:`timed_apply` record, and the
    last leg's buffered graph and the state under ``"_last"``."""
    import torch

    from repro_torch.core import CoreMaintainer
    from repro_torch.graph import BufferedGraph

    make = mixed_legs(device)
    out, first = {}, None
    for label in legs:
        bg = BufferedGraph(g)
        m = CoreMaintainer(bg, state=(r.core, r.cnt), device=device,
                           **make[label]())
        events = time_supersteps(m.backend)
        _, out[label] = timed_apply(device, m, batch, events)
        got = (m.core, m.cnt)
        if first is None:
            first = got
        check(np.array_equal(got[0], first[0])
              and np.array_equal(got[1], first[1]),
              f"{what}: {label} != {legs[0]}")
        del m
        torch.cuda.empty_cache()
    out["_last"] = (bg, first)
    return out


def phase_maintain(device, g, r) -> dict:
    """Edge-update maintenance at full width from the main path's result
    ``r``: the round trip, a no-op batch, a light batch and the mixed batch
    on three paths, each held to a fresh decompose.  Returns the kernels'
    launches over the phase's applies."""
    import torch

    from repro_torch.core import (CoreMaintainer, CudaBackend, Delete,
                                  Insert, UpdateBatch, decompose,
                                  warm_settle)
    from repro_torch.graph import BufferedGraph, CSRGraph
    from repro_torch.graph.update_cases import light_batch, mixed_batch

    state = (r.core, r.cnt)
    out = {"phase": "maintain", "n": g.n, "directed_edges": g.num_directed}
    total: dict = {}

    def count(rec):
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v

    def fresh(graph, what):
        """A cold decompose of ``graph`` on the card: the answer a batch
        must land on, independent of the maintainer's settle."""
        t = time.perf_counter()
        rf = decompose(graph, "semicore*", backend=CudaBackend(device=device))
        torch.cuda.synchronize(device)
        out[f"{what}_fresh_decompose_wall_s"] = time.perf_counter() - t
        return rf

    def held(got, rf, what):
        check(np.array_equal(got[0], rf.core)
              and np.array_equal(got[1], rf.cnt),
              f"{what}: (core, cnt) != a fresh decompose")

    # the paper's round trip: delete edges in one batch, re-insert them
    rng = np.random.default_rng(MAINTAIN_SEED)
    e = g.edge_list()
    idx = rng.choice(len(e), MAINTAIN_ROUND_TRIP, replace=False)
    pick = e[idx]
    keep = np.ones(len(e), dtype=bool)
    keep[idx] = False
    t = time.perf_counter()
    g_del = CSRGraph.from_edges(g.n, e[keep], dedup=False)
    out["round_trip_graph_build_s"] = time.perf_counter() - t
    del e, keep
    r_del = fresh(g_del, "round_trip_delete")
    del g_del
    dels = UpdateBatch(Delete(int(u), int(v)) for u, v in pick)
    ins = UpdateBatch(Insert(int(u), int(v)) for u, v in pick)
    # the delete batch per probe first: the masked settle on the segment
    # sums, from the same state
    mp = CoreMaintainer(BufferedGraph(g), state=state,
                        backend=CudaBackend(device=device, fused=False))
    s_dp, rec = timed_apply(device, mp, dels, time_supersteps(mp.backend))
    count(rec)
    check(rec["path"] == "masked" and s_dp.groups > 0,
          f"round trip: per-probe delete batch not settled masked ({s_dp})")
    check(rec["launches"].get("segment_sum_active", 0) > 0,
          "round trip: segment_sum_active never launched on the delete "
          "batch per probe")
    held((mp.core, mp.cnt), r_del, "round trip: per-probe delete batch")
    out["round_trip_delete_per_probe"] = rec
    del mp
    torch.cuda.empty_cache()
    m = CoreMaintainer(BufferedGraph(g), state=state, device=device)
    events = time_supersteps(m.backend)
    s_del, rec = timed_apply(device, m, dels, events)
    count(rec)
    check(s_del.num_deletes == MAINTAIN_ROUND_TRIP, "round trip: deletes")
    check(rec["path"] == "masked" and s_del.groups > 0,
          f"round trip: delete batch not settled masked ({s_del})")
    for name in ("row_pass", "push_pass"):
        check(rec["launches"].get(name, 0) > 0,
              f"round trip: {name} never launched on the delete batch")
    held((m.core, m.cnt), r_del, "round trip: delete batch")
    out["round_trip_delete"] = rec
    s_ins, rec = timed_apply(device, m, ins, events)
    count(rec)
    check(s_ins.num_inserts == MAINTAIN_ROUND_TRIP, "round trip: inserts")
    check(np.array_equal(m.core, r.core) and np.array_equal(m.cnt, r.cnt),
          "round trip: (core, cnt) != the main path's")
    out["round_trip_insert"] = rec
    # a batch of no-ops leaves the version, and so the retained structure:
    # a settle bound before it and one after it share one build
    warm_settle(m.engine, m.core, 0, m.backend)
    version, builds = m.bg.version, m.backend.structure_builds
    s_noop = m.apply(ins)
    rw = warm_settle(m.engine, m.core, 0, m.backend)
    check(s_noop.num_noops == MAINTAIN_ROUND_TRIP
          and m.bg.version == version
          and m.backend.structure_builds == builds,
          "no-op batch moved the version or rebuilt the structure")
    check(np.array_equal(rw.core, r.core), "settle after no-ops != main path")
    out["noop_batch"] = {
        "noops": s_noop.num_noops,
        "structure_builds": m.backend.structure_builds - builds}
    del m, rw
    torch.cuda.empty_cache()

    # deletes plus inserts planned under the cap: the grouped settle takes
    # both in the masked fixpoint, fused and per probe
    batch = UpdateBatch.from_wire(light_batch(
        g, r.core, r.cnt, MAINTAIN_ROUND_TRIP, MAINTAIN_ROUND_TRIP,
        seed=MAINTAIN_SEED))
    light = apply_legs(device, g, r, batch, list(mixed_legs(device)),
                       "light batch")
    bg, first = light.pop("_last")
    for label, rec in light.items():
        count(rec)
        if label != "serial_cuda":
            check(rec["path"] == "masked" and rec["inserts"] > 0,
                  f"light batch: {label} settled by {rec['path']}, "
                  f"{rec['inserts']} inserts")
    out["light"] = {"updates": len(batch),
                    "paths": {k: v["path"] for k, v in light.items()},
                    **light}
    t = time.perf_counter()
    final = bg.materialize()
    out["light_materialize_s"] = time.perf_counter() - t
    held(first, fresh(final, "light"), "light batch")
    del bg, final
    torch.cuda.empty_cache()

    # the mixed batch from the same state on three paths
    t = time.perf_counter()
    batch = UpdateBatch.from_wire(mixed_batch(
        g, MAINTAIN_MIXED, seed=MAINTAIN_SEED, p_delete=MAINTAIN_P_DELETE))
    out["mixed_draw_s"] = time.perf_counter() - t
    mixed = apply_legs(device, g, r, batch, list(mixed_legs(device)))
    bg, first = mixed.pop("_last")
    for rec in mixed.values():
        count(rec)
    check(mixed["serial_cuda"]["path"] == "warm_settle",
          "mixed batch: the serial leg did not run warm_settle")
    # what the three-way check compares: the parallel legs' paths
    out["mixed"] = {"updates": len(batch),
                    "paths": {k: v["path"] for k, v in mixed.items()},
                    **mixed}
    out["launches"] = dict(total)
    # last: materialize() flushes the buffer of the last leg's graph
    t = time.perf_counter()
    final = bg.materialize()
    out["materialize_s"] = time.perf_counter() - t
    held(first, fresh(final, "mixed"), "mixed batch")
    out["host_peak_rss_bytes"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    emit(out)
    return total


def query_burst(svc, nodes, lat: dict) -> dict:
    """One burst of the service's queries, each call timed into ``lat``
    (seconds by kind): ``coreness`` and ``in_kcore`` of every node in
    ``nodes`` one call each, then ``top_k(100)``, ``kcore_members`` at the
    degeneracy (its size is kcore_size) and ``degeneracy()``.  Returns
    the vector replies, each with its watermark, for comparison."""
    def timed(kind, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        lat.setdefault(kind, []).append(time.perf_counter() - t)
        return out

    deg = timed("degeneracy", svc.degeneracy)
    k = max(int(deg) // 2, 1)
    for v in nodes:
        timed("coreness", svc.coreness, int(v))
        timed("in_kcore", svc.in_kcore, int(v), k)
    top = timed("top_k", svc.top_k, 100)
    members = timed("kcore_members", svc.kcore_members, int(deg))
    return {"coreness": svc.coreness(nodes), "in_kcore": svc.in_kcore(nodes, k),
            "top_k": top, "kcore_members": members, "degeneracy": deg}


def same_replies(got: dict, want: dict, what: str) -> None:
    for kind, w in want.items():
        g = got[kind]
        check(g.epoch == w.epoch, f"{what}: {kind} watermark {g.epoch} != "
              f"{w.epoch}")
        check(np.array_equal(np.asarray(g), np.asarray(w)),
              f"{what}: {kind} reply")


def phase_stream(device, g, r) -> dict:
    """The streaming core service at full width from the main path's
    graph ``g`` and state ``r``: a writer (WAL with fsync, a snapshot every
    ``STREAM_SNAPSHOT_EVERY`` batches, two kept) ingests micro-batches 1-5
    with a query burst after each; a replica bootstraps from the epoch-4
    snapshot plus WAL record 5; batch 6 goes in and the replica syncs to
    lag 0; the writer is dropped without a snapshot and recovered from the
    snapshot plus records 5-6.  Writer, replica and recovered writer are
    held to each other and to a fresh decompose; their replies to each
    other's, watermarks included.  Returns the kernels' launches over the
    stream path (writer, bootstrap, sync, recovery)."""
    import torch

    from repro_torch.core import CudaBackend, decompose
    from repro_torch.graph.update_cases import mixed_batch
    from repro_torch.obs import trace
    from repro_torch.runtime import Settings
    from repro_torch.stream import CoreReplica, CoreWriter

    out = {"phase": "stream", "n": g.n, "directed_edges": g.num_directed,
           "batches": STREAM_BATCHES, "batch_updates": STREAM_BATCH}
    t = time.perf_counter()
    ops = mixed_batch(g, STREAM_BATCHES * STREAM_BATCH, seed=STREAM_SEED,
                      p_delete=MAINTAIN_P_DELETE)
    out["draw_s"] = time.perf_counter() - t
    batches = [ops[i:i + STREAM_BATCH] for i in range(0, len(ops),
                                                       STREAM_BATCH)]
    nodes = np.random.default_rng(STREAM_SEED).choice(
        g.n, STREAM_QUERIES, replace=False)
    total: dict = {}
    lat: dict = {}

    def traced(fn):
        """``fn()`` with the counts at 0 and a trace: (its result, wall,
        the spans' seconds by name, the launches)."""
        reset_launch_counts()
        trace.clear_trace()
        trace.start_trace()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        trace.stop_trace()
        spans: dict = {}
        for e in trace.get_collector().to_chrome()["traceEvents"]:
            if e.get("ph") == "X":
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
        launches = {k: v for k, v in launch_counts().items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return res, wall, spans, launches

    def split(spans):
        keys = ("maintenance.structural", "maintenance.plan",
                "maintenance.settle", "resident.structure", "wal.append",
                "snapshot.save", "wal.rotate")
        return {k: spans.get(k, 0.0) for k in keys}

    root = ROOT / "chiprun_out"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="stream_", dir=root) as tmp:
        wal, snaps = os.path.join(tmp, "wal.log"), os.path.join(tmp, "snaps")
        # the writer (and the recovered one) settle serially: on the
        # default parallel path every 128-update batch planned for 17-27 s
        # on the host and then fell back to warm_settle anyway (PERF.md,
        # PR 21 run 1); the replica keeps its default, as the reference's
        # has no settings
        kw = dict(wal_path=wal, snapshot_dir=snaps, snapshot_keep=2,
                  device=device, settings=Settings(backend="cuda",
                                                   parallel_maint=False))
        w, wall, _, launches = traced(lambda: CoreWriter(
            g, state=(r.core, r.cnt), wal_fsync=True,
            snapshot_every=STREAM_SNAPSHOT_EVERY, **kw))
        out["writer_start"] = {"wall_s": wall, "launches": launches}
        paths = []

        def record_paths(m):
            """Keep the MaintStats of each of ``m``'s applies in
            ``paths``: a BatchStats does not say which settle ran."""
            apply = m.apply

            def recorded(*a, **k):
                paths.append(apply(*a, **k))
                return paths[-1]

            m.apply = recorded

        record_paths(w.maintainer)
        recs = []

        def ingest(b):
            st, wall, spans, launches = traced(lambda: w.ingest(b))
            recs.append({"epoch": st.epoch, "wall_s": wall,
                         "path": settle_path(paths[-1]),
                         "algorithm": paths[-1].algorithm,
                         "deletes": st.num_applied_deletes,
                         "inserts": st.num_applied_inserts,
                         "noops": st.num_noops,
                         "supersteps": st.iterations,
                         "edge_block_reads": st.edge_block_reads,
                         "span_s": split(spans), "launches": launches})
            return query_burst(w, nodes, lat)

        for b in batches[:-1]:
            ingest(b)
        check(w.epoch == STREAM_BATCHES - 1, f"writer epoch {w.epoch}")
        snap_dir = os.path.join(snaps, f"snap_{STREAM_SNAPSHOT_EVERY:012d}")
        check(os.path.isdir(snap_dir), "no snapshot at epoch "
              f"{STREAM_SNAPSHOT_EVERY}")
        out["snapshot_bytes"] = sum(
            os.path.getsize(os.path.join(snap_dir, f))
            for f in os.listdir(snap_dir))
        t = time.perf_counter()
        w.snapshots.verify(snap_dir)
        out["manifest_check_s"] = time.perf_counter() - t

        rep, wall, spans, launches = traced(lambda: CoreReplica(
            snapshot_dir=snaps, wal_path=wal, device=device))
        record_paths(rep.maintainer)
        bs = rep.last_bootstrap
        check(bs.snapshot_epoch == STREAM_SNAPSHOT_EVERY
              and bs.replayed_batches == 1 and bs.warm_restart
              and rep.epoch == STREAM_BATCHES - 1,
              f"replica bootstrap: {bs}")
        out["bootstrap"] = {"wall_s": wall, "stats": vars(bs),
                            "span_s": {k: spans.get(k, 0.0) for k in (
                                "replica.bootstrap", "resident.structure")},
                            "launches": launches}

        want = ingest(batches[-1])
        out["ingest"] = recs
        out["snapshot_save_s"] = sum(x["span_s"]["snapshot.save"]
                                     for x in recs)
        applied, wall, spans, launches = traced(rep.sync)
        check(applied == 1 and rep.lag() == 0 and rep.epoch == w.epoch,
              f"replica sync: applied {applied}, lag {rep.lag()}")
        out["sync"] = {"wall_s": wall, "path": settle_path(paths[-1]),
                       "algorithm": paths[-1].algorithm,
                       "span_s": split(spans), "launches": launches}
        same_replies(query_burst(rep, nodes, lat), want, "replica")

        # the crash: the writer goes without a snapshot; its WAL holds 5-6
        core, cnt = w.maintainer.core.copy(), w.maintainer.cnt.copy()
        final_bg = w.bg
        w.close()
        del w
        (w2, rs), wall, spans, launches = traced(
            lambda: CoreWriter.recover(**kw))
        check(rs.warm_restart and rs.replayed_batches == 2
              and rs.snapshot_epoch == STREAM_SNAPSHOT_EVERY
              and w2.epoch == STREAM_BATCHES, f"recovery: {rs}")
        out["recovery"] = {"wall_s": wall, "stats": vars(rs),
                           "span_s": {"resident.structure": spans.get(
                               "resident.structure", 0.0)},
                           "launches": launches}
        same_replies(query_burst(w2, nodes, lat), want, "recovered writer")
        out["launches"] = dict(total)
        for name in ("row_pass", "push_pass"):
            check(total.get(name, 0) > 0,
                  f"stream: {name} never launched on the stream path")

        for what, m in (("replica", rep.maintainer),
                        ("recovered writer", w2.maintainer)):
            check(np.array_equal(m.core, core) and np.array_equal(m.cnt, cnt),
                  f"stream: {what} (core, cnt) != the writer's at epoch "
                  f"{STREAM_BATCHES}")
        t = time.perf_counter()
        final = final_bg.materialize()
        out["materialize_s"] = time.perf_counter() - t
        rf = decompose(final, "semicore*", backend=CudaBackend(device=device))
        check(np.array_equal(rf.core, core) and np.array_equal(rf.cnt, cnt),
              "stream: (core, cnt) != a fresh decompose of the final graph")
        w2.close()
        del rep, w2, final, final_bg, rf
    out["query_latency_s"] = {
        k: {"calls": len(v), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99))} for k, v in lat.items()}
    out["host_peak_rss_bytes"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    torch.cuda.empty_cache()
    emit(out)
    return total


def shard_run(device, be, fn, queue_cycles: int = 0) -> tuple:
    """``fn()`` (a run on the shard backend ``be``) traced with the counts
    at 0: returns (its result, its record: wall, supersteps, their summed
    ms and the gather's a superstep, each by CUDA events around ``be``'s
    ``superstep`` and ``gather``, the host split by span, launches, peak
    device memory, what was allocated at the start and the rise).  With
    ``queue_cycles`` each superstep is queued behind
    a device busy-wait that long, so that its events time its kernels
    alone (device time; the wall then includes the waits)."""
    import torch

    from repro_torch.obs import trace

    steps, gathers = [], []

    def timed(store, call, queue=0):
        def wrapped(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            if queue:
                torch.cuda._sleep(queue)
            s.record()
            res = call(*a, **kw)
            e.record()
            store.append((s, e))
            return res
        return wrapped

    be.superstep = timed(steps, be.superstep, queue_cycles)
    be.gather = timed(gathers, be.gather)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    allocated = torch.cuda.memory_allocated(device)
    reset_launch_counts()
    trace.clear_trace()
    trace.start_trace()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    trace.stop_trace()
    launches = {k: v for k, v in launch_counts().items() if v}
    del be.superstep, be.gather  # back to the class's methods
    spans: dict = {}
    for e in trace.get_collector().to_chrome()["traceEvents"]:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    gather_ms = [a.elapsed_time(b) for a, b in gathers]
    return res, {
        "wall_s": wall, "supersteps": getattr(res, "iterations", None),
        "supersteps_launched": len(steps),
        "superstep_ms_total": sum(a.elapsed_time(b) for a, b in steps),
        "queue_cycles": queue_cycles,
        "gather_ms_per_superstep": sum(gather_ms) / max(1, len(gather_ms)),
        "host_split_s": {k: spans.get(k, 0.0) for k in (
            "resident.structure", "resident.chunk", "cnt_prologue",
            "maintenance.structural", "maintenance.plan",
            "maintenance.settle")},
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "memory_allocated_start": allocated,
        "peak_memory_rise": torch.cuda.max_memory_allocated(device)
        - allocated}


def phase_shard(device, g, r) -> dict:
    """The shard backend at full width on the main path's graph ``g``:
    ``decompose(..., "semicore*")`` over ``[cuda:0]`` (S = 1) and
    ``[cuda:0] * SHARD_COUNT`` (and one shard a card where more than one is
    visible), each equal to the main path's result ``r`` in every field
    but the kernel-block tallies (which the shard backend does not keep);
    the same at S = SHARD_COUNT on the kernels' plain versions, equal in
    every field; then from ``r``'s (core, cnt) a ``MAINTAIN_ROUND_TRIP``-
    edge delete through ``CoreMaintainer.apply`` and a ``warm_settle`` of
    the graph less those edges, each on the shards and on "torch" (which
    counts updates as the shard does), equal in every field.  Returns the
    kernels' launches over the phase's shard runs."""
    import torch

    from repro_torch.core import (CoreMaintainer, Delete, HostEngine,
                                  ShardedBackend, TorchBackend, UpdateBatch,
                                  decompose, warm_settle)
    from repro_torch.graph import BufferedGraph

    out = {"phase": "shard", "n": g.n, "directed_edges": g.num_directed}
    total: dict = {}
    fields = ["iterations", "node_computations", "updates_per_iter",
              "computations_per_iter", "edge_block_reads", "node_table_reads"]

    def held(a, b, what, more=()):
        check(np.array_equal(a.core, b.core), f"{what}: core")
        check((a.cnt is None) == (b.cnt is None)
              and (a.cnt is None or np.array_equal(a.cnt, b.cnt)),
              f"{what}: cnt")
        for f in fields + list(more):
            check(getattr(a, f) == getattr(b, f), f"{what}: {f}")

    def count(rec, what):
        for name in ("row_pass", "push_pass"):
            check(rec["launches"].get(name, 0) > 0,
                  f"shard: {name} never launched on {what}")
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v

    layouts = {"S1": [device], f"S{SHARD_COUNT}": [device] * SHARD_COUNT}
    if torch.cuda.device_count() > 1:
        layouts["one_a_card"] = [torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count())]
    runs = {}
    for label, devs in layouts.items():
        be = ShardedBackend(devices=devs)
        be.retain_structure = True  # read its tables after the run
        res, rec = shard_run(device, be, lambda: decompose(
            g, "semicore*", backend=be))
        held(res, r, f"shard {label} vs the main path")
        count(rec, f"the {label} decompose")
        # again, each superstep queued behind a busy-wait: device time
        res_q, rec_q = shard_run(device, be, lambda: decompose(
            g, "semicore*", backend=be), SHARD_QUEUE_CYCLES)
        held(res_q, r, f"shard {label} queued vs the main path")
        rec["queued"] = {k: rec_q[k] for k in (
            "superstep_ms_total", "gather_ms_per_superstep", "queue_cycles",
            "wall_s")}
        ss = be._resident
        rec.update(num_shards=res.num_shards,
                   shard_pad_edges=res.shard_pad_edges,
                   per_shard_edges=[int(x) for x in ss.per_shard_edges],
                   per_shard_push_edges=[int(t.in_nbr.shape[0])
                                         for t in ss.shards],
                   bounds=[int(x) for x in ss.bounds])
        be.retain_structure = False
        be.unbind()
        out[label] = rec
        runs[label] = res
        torch.cuda.empty_cache()
    label = f"S{SHARD_COUNT}"
    t = time.perf_counter()
    plain = decompose(g, "semicore*", backend=ShardedBackend(
        devices=[device] * SHARD_COUNT, plain=True))
    torch.cuda.synchronize(device)
    out[f"{label}_plain_wall_s"] = time.perf_counter() - t
    held(runs[label], plain, f"shard {label} vs its plain versions",
         ["num_shards", "shard_pad_edges"])
    held(runs["S1"], plain, "shard S1 vs the plain versions")
    torch.cuda.empty_cache()

    # maintenance from the main path's (core, cnt): the delete batch on
    # the shards and on "torch", then a warm settle of the graph less it
    rng = np.random.default_rng(MAINTAIN_SEED)
    e = g.edge_list()
    pick = e[rng.choice(len(e), MAINTAIN_ROUND_TRIP, replace=False)]
    del e
    dels = UpdateBatch(Delete(int(u), int(v)) for u, v in pick)
    applied = {}
    for leg, make in (("shard", lambda: ShardedBackend(
            devices=[device] * SHARD_COUNT)),
            ("torch", lambda: TorchBackend(device=device))):
        m = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt),
                           backend=make())
        stats, rec = shard_run(device, m.backend, lambda: m.apply(dels)) \
            if leg == "shard" else timed_apply(device, m, dels, [])
        rec["path"] = settle_path(stats)
        applied[leg] = (m.core, m.cnt, stats)
        if leg == "shard":
            count(rec, "the delete batch")
        out[f"delete_batch_{leg}"] = rec
        del m
        torch.cuda.empty_cache()
    check(np.array_equal(applied["shard"][0], applied["torch"][0])
          and np.array_equal(applied["shard"][1], applied["torch"][1]),
          "shard: delete batch (core, cnt) != torch's")
    for f in ("node_computations", "edge_block_reads", "node_table_reads",
              "iterations", "num_changed", "num_deletes", "groups",
              "largest_group", "fallbacks", "settle_passes"):
        check(getattr(applied["shard"][2], f) == getattr(applied["torch"][2],
                                                         f),
              f"shard: delete batch {f} != torch's")

    def settle(backend):
        bg = BufferedGraph(g)
        for u, v in pick:
            bg.delete_edge(int(u), int(v))
        return warm_settle(HostEngine(bg), r.core, 0, backend)

    be = ShardedBackend(devices=[device] * SHARD_COUNT)
    ws, rec = shard_run(device, be, lambda: settle(be))
    count(rec, "the warm settle")
    out["warm_settle_shard"] = rec
    t = time.perf_counter()
    wt = settle(TorchBackend(device=device))
    torch.cuda.synchronize(device)
    out["warm_settle_torch_wall_s"] = time.perf_counter() - t
    held(ws, wt, "shard warm settle vs torch")
    check(np.array_equal(ws.core, applied["shard"][0])
          and np.array_equal(ws.cnt, applied["shard"][1]),
          "shard: warm settle != the delete batch's state")
    out["launches"] = dict(total)
    torch.cuda.empty_cache()
    emit(out)
    return total


def device_tables(g, device) -> dict:
    """The flat CSR on the card: segptr (n+1,), nbr and rows (E,), int32."""
    import torch

    deg = torch.as_tensor(g.degrees(), device=device)
    n = g.n
    return {
        "segptr": torch.as_tensor(g.indptr.astype(np.int32), device=device),
        "nbr": torch.as_tensor(g.adj, device=device),
        "rows": torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=device), deg,
            output_size=g.num_directed),
    }


def phase_segment_sum(device, g, ref, tables) -> dict:
    """Eq. 2 at full width through the plain segment sum: the final cnt of
    the semicore* result.  Returns the launches on this path."""
    import torch

    from repro_torch.kernels import segsum as ssk

    core = torch.as_tensor(ref.core.astype(np.int32), device=device)
    rows, nbr = tables["rows"], tables["nbr"]
    vals = (core[nbr] >= core[rows]).to(torch.int32)
    reset_launch_counts()
    cnt = ssk.segment_sum(vals, rows, g.n)
    torch.cuda.synchronize(device)
    launches = {k: v for k, v in launch_counts().items() if v}
    check(launches.get("segment_sum", 0) > 0,
          "segment_sum path: segment_sum never launched")
    check(np.array_equal(cnt.cpu().numpy(), ref.cnt),
          "segment_sum at full width != semicore* cnt")
    emit({"phase": "segment_sum", "n": g.n, "directed_edges": int(len(vals)),
          "equals_cnt": True, "launches": launches})
    return launches


def flags_reads(rows, active, block_edges: int) -> tuple:
    """(rows read, distinct node flags read) by the least reading of the
    block flags on this frontier: each block's rows up to and including
    its first active row, all of them where it has none."""
    import torch

    E = rows.shape[0]
    e = torch.arange(E, device=rows.device)
    block = e // block_edges
    hit = active[rows.long()]
    nb = -(-E // block_edges)
    first = torch.full((nb,), E, dtype=torch.int64, device=rows.device)
    first.scatter_reduce_(0, block[hit], e[hit], "amin")
    read = e <= first[block]
    return int(read.sum()), int(torch.unique(rows[read]).numel())


def baseline_module(name: str):
    """The kernel module ``name`` of the checkout under ``BASELINE_SRC``,
    loaded beside the shipped one under another package name (its kernels
    are built from its own sources into its own build directory), or
    None."""
    import importlib
    import importlib.util

    kdir = BASELINE_SRC / "repro_torch" / "kernels"
    if not (kdir / f"{name}.py").exists():
        return None
    if "port_baseline" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "port_baseline", kdir / "__init__.py",
            submodule_search_locations=[str(kdir)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["port_baseline"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"port_baseline.{name}")


def superstep_entries(g, device, tables, launches, main) -> list:
    """``row_pass`` and ``push_pass`` (semicore*) held to their plain
    versions and timed at two states of the main path: its first pass
    (every node with an edge active, cnt = 0) and the state entering pass
    ``LATE_PASS``; beside them the pair of the checkout under
    ``BASELINE_SRC`` when there is one, by the same clock (``device_ms``),
    and each kernel of a call by the profiler.  The entries also carry the
    main path's superstep times (both clocks) and its bound."""
    import torch

    from repro_torch.kernels import fused_superstep as fsk

    star = fsk.MODE_SEMICORE_STAR
    deg = g.degrees()
    n = g.n
    segptr, nbr = tables["segptr"], tables["nbr"]
    deg_t = torch.as_tensor(deg, device=device)
    plan = fsk.bin_plan(segptr)
    baseline = baseline_module("fused_superstep")
    states = {
        "first": {"core": torch.as_tensor(deg.astype(np.int32),
                                          device=device),
                  "cnt": torch.zeros(n, dtype=torch.int32, device=device),
                  "active": torch.as_tensor(deg > 0, device=device)},
        "late": main["late"]}
    at = {"row_pass": {}, "push_pass": {}}
    for label, st in states.items():
        core, cnt, active = st["core"], st["cnt"], st["active"]
        reps = 10 if label == "first" else 50

        def row(mod=fsk, **kw):
            return mod.row_pass(star, segptr, nbr, core, cnt, active, **kw)

        def push(tgt, core2, mod=fsk, **kw):
            mod.push_pass(star, segptr, nbr, core, core2, active, tgt, **kw)

        got = row(plan=plan)
        want = fsk.row_pass_plain(star, segptr, nbr, core, cnt, active)
        row_err = max(int((got[i] - want[i]).abs().max()) for i in range(2))
        row_err = max(row_err, abs(int(got[2]) - int(want[2])))
        core2, cnt2 = want[0], want[1]
        tgt, tgt_plain = cnt2.clone(), cnt2.clone()
        push(tgt, core2, plan=plan)
        fsk.push_pass_plain(star, segptr, nbr, core, core2, active, tgt_plain)
        push_err = int((tgt - tgt_plain).abs().max())
        check(row_err == 0 and push_err == 0,
              f"superstep pair != plain at the {label} pass")
        e_row = int(deg_t[active].sum())
        e_push = int(deg_t[active & (core2 != core)].sum())
        scratch = cnt2.clone()
        times = {
            "row_pass": (row_err, e_row, row_bytes(n, e_row),
                         device_ms(lambda: row(plan=plan), reps, device),
                         cuda_ms(lambda: fsk.row_pass_plain(
                             star, segptr, nbr, core, cnt, active), 2,
                             device)),
            "push_pass": (push_err, e_push, push_bytes(n, e_push),
                          device_ms(lambda: push(scratch, core2, plan=plan),
                                    reps, device),
                          cuda_ms(lambda: fsk.push_pass_plain(
                              star, segptr, nbr, core, core2, active,
                              scratch), 2, device))}
        base = {}
        if baseline is not None:
            b = row(mod=baseline)
            bt = cnt2.clone()
            push(bt, core2, mod=baseline)
            check(all(torch.equal(x, y) for x, y in zip(b, want))
                  and torch.equal(bt, tgt_plain),
                  f"baseline superstep pair != plain at the {label} pass")
            base = {"row_pass": device_ms(lambda: row(mod=baseline), reps,
                                          device),
                    "push_pass": device_ms(lambda: push(scratch, core2,
                                                        mod=baseline),
                                           reps, device)}
        # each kernel of the pair's calls, by the profiler (3 calls each)
        kernels = {
            "row_pass": device_profile(
                lambda: [row(plan=plan) for _ in range(3)], top=8),
            "push_pass": device_profile(
                lambda: [push(scratch, core2, plan=plan) for _ in range(3)],
                top=8)}
        for name, (err, edges, nbytes, ms, pms) in times.items():
            bms, by = bound(nbytes, edges)
            prof = kernels[name]["top_kernels_ms"]
            at[name][label] = {
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "baseline_ms": base.get(name),
                "frontier_rows": int(active.sum()), "active_edges": edges,
                "bytes": nbytes,
                "profiled_ms_per_call": {k: v / 3 for k, v in prof.items()}}

    entries = []
    for name, t in at.items():
        first, late = t["first"], t["late"]
        entries.append({
            "name": name, "route": "cuda", "source": FUSED_SOURCE,
            "replaces": FUSED_REPLACES, "launches": launches[name],
            "max_abs_err": max(first["max_abs_err"], late["max_abs_err"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "parity": "bit-identical",
            "profiled_ms_per_call": first["profiled_ms_per_call"],
            "late_pass": {"pass": LATE_PASS, **late},
            "baseline": None if baseline is None else {
                "src": str(BASELINE_SRC.relative_to(ROOT)),
                "ms": first["baseline_ms"], "late_ms": late["baseline_ms"]},
            "main_path_superstep_ms": main["superstep_ms"],
            "main_path_superstep_device_ms": main["superstep_device_ms"],
            "main_path_superstep_bound_ms": main["superstep_bound_ms"],
            "shape": {"n": n, "directed_edges": g.num_directed,
                      "active_edges": first["active_edges"],
                      "bytes": first["bytes"]}})
    return entries


def kernel_entries(g, device, tables, launches, main) -> list:
    """The superstep pair (:func:`superstep_entries`), then the segment
    sums (:func:`segsum_entries`)."""
    return superstep_entries(g, device, tables, launches, main) + \
        segsum_entries(g, device, tables, launches, main)


def segsum_entries(g, device, tables, launches, main) -> list:
    """The segment sums at the first h-index probe (D = 1, int32, the
    engine's 512-edge blocks) of two states of the per-probe decompose:
    its first pass (every node with an edge active, core = degree) and the
    state entering pass ``LATE_PASS`` (the main path's, which the per-probe
    path goes through pass for pass).  At each, every kernel is held to its
    plain version, timed by :func:`device_ms` in turns with the kernels of
    the checkout under ``BASELINE_SRC`` when there is one, and bounded by
    the bytes that state needs: the rows up to each block's first active
    row (block_flags, plus the flags and the list written), the walked
    blocks' rows and values (8 B an edge), the list and the output written
    once (the sums)."""
    import torch

    from repro_torch.kernels import segsum as ssk, segsum_active as ssa

    n, E, be = g.n, g.num_directed, 512
    nb = -(-E // be)
    nbr, rows = tables["nbr"], tables["rows"]
    deg = g.degrees()
    base_ss = baseline_module("segsum")
    base_ssa = baseline_module("segsum_active")
    block_len = torch.full((nb,), be, dtype=torch.int64, device=device)
    block_len[-1] = E - (nb - 1) * be
    states = {"first": (torch.as_tensor(deg.astype(np.int32), device=device),
                        torch.as_tensor(deg > 0, device=device)),
              "late": (main["late"]["core"], main["late"]["active"])}
    at = {"block_flags": {}, "segment_sum_active": {}, "segment_sum": {}}
    for label, (core, active) in states.items():
        reps = 20 if label == "first" else 50
        # the pass's first probe: lo = 0, hi = c_old, mid = (c_old + 1) // 2
        mid = (torch.where(active, core, 0) + 1) // 2
        vals = (core[nbr] >= mid[rows]).to(torch.int32)
        flags, ids, count = ssa.active_blocks(rows, active, be)
        blocks = (ids, count)
        check(torch.equal(flags, ssa.block_flags_plain(rows, active, be))
              and same_list(ids, count, flags),
              f"block flags or their list != plain at the {label} probe")
        n_act = int(flags.sum())
        e_act = int(block_len[flags.bool()].sum())
        rows_read, nodes_read = flags_reads(rows, active, be)
        want = {"segment_sum_active": ssa.segsum_active_plain(
                    vals, rows, flags, n, be),
                "segment_sum": ssk.segment_sum_plain(vals, rows, n, be)}

        def library():  # one PyTorch call computing the same sum
            return torch.zeros(n, dtype=torch.int32, device=device
                               ).index_add_(0, rows, vals)

        check(torch.equal(want["segment_sum"], library()),
              f"segment_sum_plain != index_add_ at the {label} probe")

        # name: (kernel, plain, baseline kernel, bytes, operations,
        #        library where it computes the same function)
        timed = {
            "block_flags": (
                lambda: ssa.active_blocks(rows, active, be),
                lambda: ssa.active_blocks_plain(rows, active, be),
                base_ssa and (lambda: base_ssa.block_flags(rows, active, be)),
                4 * rows_read + nodes_read + 4 * nb + 4 * n_act + 4,
                rows_read, None),
            "segment_sum_active": (
                lambda: ssa.segsum_active(vals, rows, flags, n, be,
                                          blocks=blocks),
                lambda: ssa.segsum_active_plain(vals, rows, flags, n, be),
                base_ssa and (lambda: base_ssa.segsum_active(
                    vals, rows, flags, n, be)),
                8 * e_act + 4 * n_act + 4 + 4 * n, e_act,
                library if n_act == nb else None),
            "segment_sum": (
                lambda: ssk.segment_sum(vals, rows, n, be),
                lambda: ssk.segment_sum_plain(vals, rows, n, be),
                base_ss and (lambda: base_ss.segment_sum(vals, rows, n, be)),
                8 * E + 4 * n, E, library)}
        for name, (fn, plain, base, nbytes, ops, lib) in timed.items():
            err = 0
            if name != "block_flags":
                err = int((fn() - want[name]).abs().max())
                check(err == 0, f"{name} != plain at the {label} probe")
                if base is not None:
                    check(torch.equal(base(), want[name]),
                          f"baseline {name} != plain at the {label} probe")
            ms, base_ms = [], []
            for _ in range(2):  # in turns: kernel, baseline, kernel, baseline
                ms.append(device_ms(fn, reps, device))
                if base is not None:
                    base_ms.append(device_ms(base, reps, device))
            bms, by = bound(nbytes, ops)
            at[name][label] = {
                "max_abs_err": err, "ms": min(ms), "plain_ms": cuda_ms(
                    plain, 3, device),
                "bound_ms": bms, "bound_by": by,
                "library_ms": None if lib is None else device_ms(
                    lib, reps, device),
                "baseline_ms": min(base_ms) if base_ms else None,
                "active_blocks": n_act, "active_edges": e_act,
                "bytes": nbytes,
                **({"rows_read": rows_read, "nodes_read": nodes_read}
                   if name == "block_flags" else {})}

    entries = []
    for name, t in at.items():
        first, late = t["first"], t["late"]
        entries.append({
            "name": name, "route": "cuda", "source": SEGSUM_SOURCE,
            "replaces": SEGSUM_REPLACES[name], "launches": launches[name],
            "max_abs_err": max(first["max_abs_err"], late["max_abs_err"]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "parity": "bit-identical",
            "late_probe": {"pass": LATE_PASS, **late},
            "baseline": None if base_ss is None else {
                "src": str(BASELINE_SRC.relative_to(ROOT)),
                "ms": first["baseline_ms"], "late_ms": late["baseline_ms"]},
            "shape": {"n": n, "directed_edges": E, "block_edges": be,
                      "blocks": nb, "D": 1, "dtype": "int32", **{
                          k: first[k] for k in first if k in (
                              "active_blocks", "active_edges", "bytes",
                              "rows_read", "nodes_read")}}})
    return entries


def device_profile(fn, top: int = 6, groups: dict | None = None) -> dict:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity): wall, the
    device time the kernels took, the device's busy share of the wall, the
    ``top`` kernels by device time and, for ``groups`` ({label: name
    substrings}), the device time of the kernels whose name holds one of
    a group's substrings (``group_ms``, the rest under "other").  Device
    times are None when the profiler records none (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    out = {"wall_ms": wall * 1e3,
           "device_ms": busy_us / 1e3 if kernels else None,
           "device_busy_share": busy_us / 1e6 / wall if kernels else None,
           "kernels_launched": sum(e.count for e in kernels),
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in by_time}}
    if groups:
        group_ms = {label: 0.0 for label in (*groups, "other")}
        for e in kernels:
            label = next((k for k, subs in groups.items()
                          if any(x in e.key for x in subs)), "other")
            group_ms[label] += e.self_device_time_total / 1e3
        out["group_ms"] = group_ms if kernels else None
    return out


# ------------------------------------------------------------ serving
def _retrieval_agrees(vals, idx, vals_p, idx_p, tol) -> int:
    """Top-k values within ``tol`` of the plain run's, and indices equal
    wherever the plain scores on both sides differ by more than the
    tolerance (``vals_p``/``idx_p`` hold one more entry than ``vals``);
    returns the positions held to equal indices."""
    import torch

    rtol, atol = tol
    k = vals.shape[-1]
    _close(vals, vals_p[..., :k], tol, "retrieval: top-k values")
    v = vals_p.float()
    gap = (v[..., :-1] - v[..., 1:]).abs()
    lim = atol + rtol * v[..., 1:].abs()
    sep = gap > lim                          # (B, k): i apart from i + 1
    left = torch.cat([torch.ones_like(sep[..., :1]), sep[..., :k - 1]], -1)
    firm = left & sep
    check(bool((idx[firm] == idx_p[..., :k][firm]).all()),
          "retrieval: top-k indices differ where the scores are apart")
    return int(firm.sum())


def phase_mind(device) -> tuple:
    """Full-width MIND serving on the embedding-bag kernel, each cell held
    to the plain bag on the card.  Returns the main path's launches, the
    profile table and serve_bulk's profile bags (for the kernels line)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data import RecsysSource
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.models import recsys as rec
    from repro_torch.models.params import tree_num_params

    cfg = get_config("mind")
    t = time.perf_counter()
    params = rec.mind_init(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize(device)
    out = {"phase": "mind", "params": tree_num_params(
        rec.mind_param_specs(cfg)), "init_s": time.perf_counter() - t,
        "tolerance": list(MIND_TOL), "cells": {}}
    launches = 0

    def on_card(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
                if k in ("hist_ids", "profile_ids", "candidate_ids")}

    with torch.inference_mode():
        # serve_p99: 100 requests of 512 users, one at a time
        B = RECSYS_SHAPES["serve_p99"]["batch"]
        reqs = [on_card(RecsysSource(cfg, B, seed=1)(i)) for i in range(100)]
        rec.mind_serve(params, cfg, reqs[0])  # warm
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        walls = []
        for b in reqs:
            t = time.perf_counter()
            got = rec.mind_serve(params, cfg, b)
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t)
        n = launch_counts()["embedding_bag"]
        check(n > 0, "serve_p99: embedding_bag never launched")
        launches += n
        ebk.raise_bad_index(device)
        with plain_serving():
            want = rec.mind_serve(params, cfg, reqs[-1])
        prof = device_profile(lambda: [rec.mind_serve(params, cfg, b)
                                       for b in reqs[:10]])
        ms = np.sort(np.array(walls) * 1e3)
        out["cells"]["serve_p99"] = {
            "batch": B, "requests": len(reqs), "launches": n,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms[-1]),
            "users_per_s": B * len(reqs) / sum(walls),
            "max_abs_err": _close(got, want, MIND_TOL, "mind serve_p99"),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "profile_10_requests": prof}
        del reqs

        # serve_bulk: 262,144 users in one call
        B = RECSYS_SHAPES["serve_bulk"]["batch"]
        t = time.perf_counter()
        b = on_card(RecsysSource(cfg, B, seed=1)(0))
        host_s = time.perf_counter() - t
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t = time.perf_counter()
        got = rec.mind_serve(params, cfg, b)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        n = launch_counts()["embedding_bag"]
        check(n > 0, "serve_bulk: embedding_bag never launched")
        launches += n
        peak = torch.cuda.max_memory_allocated(device)
        t = time.perf_counter()
        again = rec.mind_serve(params, cfg, b)
        torch.cuda.synchronize(device)
        warm = time.perf_counter() - t
        check(bool(torch.isfinite(got).all()) and got.shape == (
            B, cfg.n_interests, cfg.embed_dim), "serve_bulk: shape or finite")
        check(torch.equal(got, again), "serve_bulk: a rerun differs")
        err, step = 0.0, 32768  # the plain bag's gathered rows, sliced
        ebk.raise_bad_index(device)
        for i in range(0, B, step):
            part = {k: v[i:i + step] for k, v in b.items()}
            with plain_serving():
                want = rec.mind_serve(params, cfg, part)
            err = max(err, _close(got[i:i + step], want, MIND_TOL,
                                  "mind serve_bulk"))
        out["cells"]["serve_bulk"] = {
            "batch": B, "bags": B * cfg.n_profile_fields, "launches": n,
            "wall_s": wall, "rerun_wall_s": warm, "host_batch_s": host_s,
            "users_per_s": B / min(wall, warm), "max_abs_err": err,
            "max_memory_allocated": peak,
            "profile": device_profile(lambda: rec.mind_serve(params, cfg, b))}
        profile_ids = b["profile_ids"]
        del b, got, again

        # retrieval_cand: one user against every item, top 100
        sh = RECSYS_SHAPES["retrieval_cand"]
        b = on_card(RecsysSource(cfg, sh["batch"], seed=1)(0))
        b["candidate_ids"] = torch.arange(sh["n_candidates"],
                                          dtype=torch.int32, device=device)
        rec.mind_retrieval(params, cfg, b)  # warm
        torch.cuda.synchronize(device)
        reset_launch_counts()
        t = time.perf_counter()
        vals, idx = rec.mind_retrieval(params, cfg, b, top_k=100)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        n = launch_counts()["embedding_bag"]
        check(n > 0, "retrieval_cand: embedding_bag never launched")
        launches += n
        ebk.raise_bad_index(device)
        with plain_serving():
            vals_p, idx_p = rec.mind_retrieval(params, cfg, b, top_k=101)
        firm = _retrieval_agrees(vals, idx, vals_p, idx_p, MIND_TOL)
        out["cells"]["retrieval_cand"] = {
            "candidates": sh["n_candidates"], "top_k": 100, "launches": n,
            "wall_ms": wall * 1e3, "indices_held_equal": firm,
            "max_abs_err": float((vals - vals_p[..., :100]).abs().max()),
            "profile": device_profile(lambda: rec.mind_retrieval(params, cfg,
                                                                 b))}
    emit(out)
    return {"embedding_bag": launches}, params["profile_embed"], profile_ids


def phase_lm(device) -> tuple:
    """Full-width Qwen3-0.6B behind ServeEngine on the flash-decode kernels,
    replayed teacher-forced beside the plain attention.  Returns the main
    path's launches and, for the lm_prefill phase, the weights, the
    prompts and the engine's logits after the last prompt token."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import tree_num_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3-0.6b")
    t = time.perf_counter()
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize(device)
    out = {"phase": "lm_serve", "arch": cfg.name,
           "params": tree_num_params(tfm.lm_param_specs(cfg)),
           "init_s": time.perf_counter() - t, "slots": LM_SLOTS,
           "max_len": LM_MAX_LEN, "prompt": LM_PROMPT,
           "generate": LM_GENERATE, "logits_atol": LM_LOGITS_ATOL}
    prompts = TokenSource(LM_SLOTS, LM_PROMPT, cfg.vocab, seed=0)(0)["tokens"]
    steps = LM_PROMPT + LM_GENERATE

    # warm the kernels and the allocator on a short engine
    ServeEngine(params, cfg, LM_SLOTS, 64, device=device).generate(
        prompts[:, :8], 2)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=device)
    events = []
    decode = eng.decode
    prefill_logits = []

    def timed_decode(tokens):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits = decode(tokens)
        e.record()
        events.append((s, e))
        if len(events) == LM_PROMPT:  # the prefill's last step
            prefill_logits.append(logits)
        return logits

    eng.decode = timed_decode
    # the main path: launch counts set to 0 just before, read just after
    reset_launch_counts()
    t = time.perf_counter()
    toks = eng.generate(prompts, LM_GENERATE)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    check_decode_launches(launches, steps, cfg.n_layers, "lm_serve")
    check(toks.shape == (LM_SLOTS, LM_GENERATE)
          and ((toks >= 0) & (toks < cfg.vocab)).all(), "lm_serve: tokens")
    # stream time between events around each step (host gaps included)
    ev_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    out.update(
        wall_s=wall, decode_steps=steps, ms_per_step=wall * 1e3 / steps,
        event_ms_per_step=float(np.mean(ev_ms)),
        event_ms_per_step_generate=float(np.mean(ev_ms[LM_PROMPT:])),
        tokens_per_s=LM_SLOTS * steps / wall,
        launches=launches, cache_bytes=2 * eng.caches["k"].numel() * 2,
        max_memory_allocated=torch.cuda.max_memory_allocated(device))
    # where a step's time goes: 8 more decode steps under the profiler
    tok = torch.as_tensor(toks[:, -1:], device=device)
    out["profile_8_steps"] = device_profile(
        lambda: [decode(tok) for _ in range(8)])
    del eng

    # teacher-forced replay: the kernel engine and a plain-attention engine
    # on the kernel run's token stream (a flipped near-tie cannot fork them);
    # the plain engine's cache ends at the stream's length, which changes no
    # result (positions past len weigh exactly 0)
    with torch.inference_mode():
        stream = torch.as_tensor(np.concatenate([prompts, toks], axis=1),
                                 device=device)
        ek = ServeEngine(params, cfg, LM_SLOTS, LM_MAX_LEN, device=device)
        ep = ServeEngine(params, cfg, LM_SLOTS, steps, device=device)
        worst = torch.zeros((), device=device)
        firm = torch.zeros((), dtype=torch.int64, device=device)
        flips = torch.zeros((), dtype=torch.int64, device=device)
        same_tok = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(steps):
            lk = ek.decode(stream[:, i:i + 1])[:, -1].float()
            with plain_serving():
                lp = ep.decode(stream[:, i:i + 1])[:, -1].float()
            worst = torch.maximum(worst, (lk - lp).abs().max())
            top = lp.topk(2, dim=-1)
            sure = (top.values[:, 0] - top.values[:, 1]) > LM_LOGITS_ATOL
            agree = lk.argmax(dim=-1) == top.indices[:, 0]
            firm += sure.sum()
            flips += (sure & ~agree).sum()
            if i >= LM_PROMPT - 1 and i < steps - 1:  # replays the tokens
                same_tok += (lk.argmax(dim=-1) == stream[:, i + 1]).sum()
        worst, firm, flips, same_tok = (float(worst), int(firm), int(flips),
                                        int(same_tok))
    check(worst <= LM_LOGITS_ATOL, f"lm_serve: logits differ by {worst} > "
          f"{LM_LOGITS_ATOL}")
    check(flips == 0, f"lm_serve: {flips} greedy tokens differ where the "
          "plain top-2 gap exceeds the tolerance")
    out.update(max_abs_logit_err=worst, greedy_held_equal=firm,
               replay_tokens_equal=same_tok,
               replay_tokens=LM_SLOTS * LM_GENERATE)
    emit(out)
    return launches, {"params": params, "prompts": prompts,
                      "prefill_logits": prefill_logits[0]}


@contextlib.contextmanager
def recorded_routing():
    """``moe_apply`` as the transformer calls it, each call's routing
    recorded: the top-k expert ids of its tokens (T, k), sorted, as
    ``moe_apply`` draws them from its input and router."""
    import torch

    from repro_torch.models import transformer as tfm

    seen, inner = [], tfm.moe_apply

    def recording(p, cfg, x, *args, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        seen.append(torch.topk(probs, cfg.moe.top_k).indices.sort(-1).values)
        return inner(p, cfg, x, *args, **kw)

    tfm.moe_apply = recording
    try:
        yield seen
    finally:
        tfm.moe_apply = inner


def free_card(device) -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def hold_decode_vs_full(device, cfg, params, prompts) -> dict:
    """A fresh engine's teacher-forced decode logits at every prompt
    position against the cache-free forward over the same prompts, each
    position's largest |difference| held to :data:`ZOO_LOGITS_REL` of the
    cache-free logits' std.  MoE: the cache-free side runs at a capacity
    factor that drops nothing (C >= T, this check only), a decode step
    drops nothing (C >= slots); positions whose tokens took other experts
    on the two sides in some MoE layer are counted, not held, and the
    pairs that agree must be :data:`MOE_ROUTING_AGREE` of all.  Where the
    cache-free top-2 gap exceeds the tolerance, the greedy tokens agree."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_capacity
    from repro_torch.serve import ServeEngine

    B, S = prompts.shape
    full_cfg = cfg
    if cfg.moe is not None:
        m = cfg.moe
        full_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
        check(moe_capacity(full_cfg.moe, B * S) >= B * S
              and moe_capacity(m, B) >= B, f"{cfg.name}: a hold side drops")
    tok = torch.as_tensor(prompts, device=device)
    with torch.inference_mode(), recorded_routing() as routes:
        eng = ServeEngine(params, cfg, B, S, device=device)
        steps = torch.stack([eng.decode(tok[:, i:i + 1])[:, 0]
                             for i in range(S)], dim=1).float()
        n_dec = len(routes)
        del eng
        hidden, _ = tfm.lm_forward(params, full_cfg, tok)
        full = tfm.lm_logits(params, full_cfg, hidden).float()
        del hidden
    agree = torch.ones((B, S), dtype=torch.bool, device=device)
    out = {}
    if cfg.moe is not None:
        n_moe = len(routes) - n_dec
        k = cfg.moe.top_k
        check(n_dec == S * n_moe, f"{cfg.name}: {n_dec} decode routings")
        dec = torch.stack(routes[:n_dec]).reshape(S, n_moe, B, k)
        ful = torch.stack(routes[n_dec:]).reshape(n_moe, B, S, k)
        same = (dec.permute(2, 0, 1, 3) == ful.permute(1, 2, 0, 3)).all(-1)
        agree = same.all(-1)
        share = float(same.float().mean())
        out.update(moe_layers=n_moe, routing_pairs=B * S * n_moe,
                   routing_agree_share=share,
                   positions_rerouted=int((~agree).sum()))
        check(share >= MOE_ROUTING_AGREE, f"{cfg.name}: decode and the "
              f"cache-free form route {share:.4f} of the pairs alike")
    err = (steps - full).abs().amax(-1)
    tol = ZOO_LOGITS_REL * float(full.std())
    held = float(err[agree].max())
    top = full.topk(2, dim=-1)
    sure = (top.values[..., 0] - top.values[..., 1]) > tol
    flips = int((sure & agree & (steps.argmax(-1) != top.indices[..., 0]))
                .sum())
    out.update(positions=B * S, logits_std=float(full.std()),
               logits_tol=tol, max_abs_logit_err=held,
               max_abs_logit_err_rerouted=float(err[~agree].max())
               if bool((~agree).any()) else None,
               greedy_held_equal=int((sure & agree).sum()))
    check(bool(torch.isfinite(full).all() and torch.isfinite(steps).all()),
          f"{cfg.name}: logits not finite")
    check(held <= tol, f"{cfg.name}: decode logits differ from the "
          f"cache-free form by {held} > {tol}")
    check(flips == 0, f"{cfg.name}: {flips} greedy tokens differ where the "
          "cache-free top-2 gap exceeds the tolerance")
    return out


def zoo_serve(device, cfg, params, prompts) -> tuple:
    """``ServeEngine(ZOO_SLOTS, ZOO_PROMPT + ZOO_GENERATE)``: the prompts
    through decode steps, then :data:`ZOO_GENERATE` greedy tokens, each
    step between CUDA events, the launch counts set to 0 just before and
    read just after; then :func:`hold_decode_vs_full`.  Returns (record,
    launches)."""
    import torch

    from repro_torch.serve import ServeEngine

    steps = ZOO_PROMPT + ZOO_GENERATE
    # warm the kernels and the allocator on a short engine
    ServeEngine(params, cfg, ZOO_SLOTS, 8, device=device).generate(
        prompts[:, :4], 2)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(params, cfg, ZOO_SLOTS, steps, device=device)
    events, decode = [], eng.decode

    def timed_decode(tokens):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits = decode(tokens)
        e.record()
        events.append((s, e))
        return logits

    eng.decode = timed_decode
    reset_launch_counts()
    t = time.perf_counter()
    toks = eng.generate(prompts, ZOO_GENERATE)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    launches = {k: v for k, v in launch_counts().items() if v}
    check(toks.shape == (ZOO_SLOTS, ZOO_GENERATE)
          and ((toks >= 0) & (toks < cfg.vocab)).all(), f"{cfg.name}: tokens")
    ev_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    rec = {"slots": ZOO_SLOTS, "prompt": ZOO_PROMPT,
           "generate": ZOO_GENERATE, "decode_steps": steps, "wall_s": wall,
           "ms_per_step": wall * 1e3 / steps,
           "event_ms_per_step": float(np.mean(ev_ms)),
           "event_ms_per_step_generate": float(np.mean(ev_ms[ZOO_PROMPT:])),
           "tokens_per_s": ZOO_SLOTS * steps / wall, "launches": launches,
           "cache_bytes": sum(c.numel() * c.element_size()
                              for c in eng.caches.values()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    del eng
    rec["decode_vs_cache_free"] = hold_decode_vs_full(device, cfg, params,
                                                      prompts)
    return rec, launches


def zoo_model(device, cfg) -> tuple:
    """``cfg``'s weights drawn on the card from seed 0: (params, record)."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import tree_num_params

    t = time.perf_counter()
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize(device)
    return params, {"arch": cfg.name, "n_layers": cfg.n_layers,
                    "params": tree_num_params(tfm.lm_param_specs(cfg)),
                    "init_s": time.perf_counter() - t,
                    "weights_bytes": torch.cuda.memory_allocated(device)}


def check_decode_launches(launches, steps: int, layers: int, what: str):
    for name in ("flash_decode", "flash_decode_combine"):
        check(launches.get(name, 0) == steps * layers,
              f"{what}: {name} launched {launches.get(name, 0)} times, not "
              f"{steps} steps x {layers} layers")


def plain_attention_rows(q, k, v, rows: int):
    """The last ``rows`` query rows of causal GQA attention over every key,
    one masked float32 softmax (the (rows, T) scores formed whole), in
    q's dtype."""
    import torch

    B, S, H, d = q.shape
    G = H // k.shape[2]
    qf = q[:, -rows:].float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf) / (d ** 0.5)
    q_pos = torch.arange(S - rows, S, device=q.device)[:, None]
    s.masked_fill_(torch.arange(k.shape[1], device=q.device) > q_pos,
                   float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def phase_lm_prefill(device, held) -> dict:
    """Qwen3-0.6B's cache-free prefill at full width: ``serve_prefill`` on
    phase_lm's prompts held to the engine's logits after the last prompt
    token; the prefill_32k cell (B = 2, S = 32,768) timed; the chunked
    attention of one layer at S = 32,768 held on its last rows to one
    masked softmax over all keys.  Then Qwen3-14B at full depth behind
    ServeEngine (:func:`zoo_serve`), flash decode under all 40 layers.
    Returns Qwen3-14B's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import chunked_attention, rms_norm

    # lm_serve's engines hold ~30 GB of caches in reference cycles (the
    # timed decode wrapped on the engine): collect them first
    free_card(device)
    cfg = get_config("qwen3-0.6b")
    params = held.pop("params")
    out = {"phase": "lm_prefill", "arch": cfg.name,
           "logits_atol": LM_LOGITS_ATOL,
           "reduced": {"prefill_32k_batch": [32, PREFILL_B]}}
    with torch.inference_mode():
        got = tfm.serve_prefill(params, cfg, torch.as_tensor(
            held["prompts"], device=device))
        err = float((got.float() - held["prefill_logits"].float())
                    .abs().max())
        check(err <= LM_LOGITS_ATOL, f"lm_prefill: serve_prefill differs "
              f"from the engine's prefill by {err} > {LM_LOGITS_ATOL}")
        out["serve_prefill_vs_engine"] = {
            "prompts": list(held["prompts"].shape), "max_abs_logit_err": err}
        tokens = torch.as_tensor(TokenSource(PREFILL_B, PREFILL_S, cfg.vocab,
                                             seed=1)(0)["tokens"],
                                 device=device)
        tfm.serve_prefill(params, cfg, tokens[:, :PREFILL_WARM_S])
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        logits = tfm.serve_prefill(params, cfg, tokens)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        check(logits.shape == (PREFILL_B, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()), "lm_prefill: logits")
        out["prefill_32k"] = {
            "B": PREFILL_B, "S": PREFILL_S, "wall_s": wall,
            "tokens_per_s": PREFILL_B * PREFILL_S / wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
        # one layer's attention at S = 32,768, timed and held
        lp = tfm._layer_slice(params["layers"], 0)
        x = rms_norm(params["embed"][tokens.long()].to(cfg.dtype),
                     lp["ln_attn"])
        pos = torch.arange(PREFILL_S, device=device).expand(PREFILL_B,
                                                            PREFILL_S)
        q, k, v = tfm._gqa_qkv(lp["attn"], cfg, x, pos)
        del x, logits
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        o = chunked_attention(q, k, v)
        e_ev.record()
        torch.cuda.synchronize(device)
        H, d = q.shape[2], q.shape[3]
        # the causal work: every (query, key <= query) pair, QK and PV
        flops = 4 * PREFILL_B * H * d * PREFILL_S * (PREFILL_S + 1) // 2
        attn_ms = s_ev.elapsed_time(e_ev)
        R = PREFILL_HELD_ROWS
        err, lim = bf16_hold(o[:, -R:], plain_attention_rows(q, k, v, R))
        check(err <= lim, f"lm_prefill: chunked_attention's last {R} rows "
              f"differ from the plain softmax by {err} > {lim}")
        out["chunked_attention_layer"] = {
            "q": list(q.shape), "k": list(k.shape), "ms": attn_ms,
            "causal_flops": flops,
            "tflops_per_s": flops / attn_ms / 1e9,
            "bound_ms": bound(0, flops, F32_OPS_PER_S)[0],
            "held_rows": R, "max_abs_err": err, "limit": lim,
            "tolerance": "2**-7 * max|want| (float32 scores, bf16 out)"}
        del q, k, v, o, tokens
    del params
    free_card(device)
    emit(out)

    cfg = get_config("qwen3-14b")
    params, rec = zoo_model(device, cfg)
    prompts = TokenSource(ZOO_SLOTS, ZOO_PROMPT, cfg.vocab, seed=0)(0)[
        "tokens"]
    serve, launches = zoo_serve(device, cfg, params, prompts)
    check_decode_launches(launches, ZOO_PROMPT + ZOO_GENERATE, cfg.n_layers,
                          "lm_prefill qwen3-14b")
    del params
    free_card(device)
    emit({"phase": "lm_prefill", **rec, "serve": serve,
          "logits_rel": ZOO_LOGITS_REL})
    return launches


def phase_lm_moe(device) -> dict:
    """DeepSeek-V3-671B (MLA, the latent-cache decode) and Arctic-480B
    (flash decode, G = 7) at full width, depth cut (:data:`ZOO_DEPTH`):
    ServeEngine (:func:`zoo_serve`, each model's decode held to its
    cache-free forward), then ``serve_prefill`` at :data:`MOE_PREFILL`,
    timed, with the share of (token, expert) assignments dropped at the
    published capacity factor in each routed layer.  Each model is freed
    before the next.  Returns Arctic's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_capacity

    arctic = {}
    for arch, (depth, dense) in ZOO_DEPTH.items():
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=depth, moe=dataclasses.replace(
            base.moe, first_k_dense=dense))
        params, rec = zoo_model(device, cfg)
        rec["reduced"] = {"n_layers": [base.n_layers, depth],
                          "first_k_dense": [base.moe.first_k_dense, dense],
                          "prefill_32k": [[32, 32768], list(MOE_PREFILL)]}
        prompts = TokenSource(ZOO_SLOTS, ZOO_PROMPT, cfg.vocab, seed=0)(0)[
            "tokens"]
        serve, launches = zoo_serve(device, cfg, params, prompts)
        # GQA decode runs kernel #5 under every layer; MLA's latent decode
        # is the reference's einsum form, no kernel
        check_decode_launches(launches, ZOO_PROMPT + ZOO_GENERATE,
                              cfg.n_layers if cfg.mla is None else 0,
                              f"lm_moe {arch}")
        if cfg.mla is None:
            arctic = launches
        B, S = MOE_PREFILL
        tokens = torch.as_tensor(TokenSource(B, S, cfg.vocab, seed=1)(0)[
            "tokens"], device=device)
        C = moe_capacity(cfg.moe, B * S)
        with torch.inference_mode():
            with recorded_routing() as routes:  # and the warm call
                tfm.serve_prefill(params, cfg, tokens)
            X, k = cfg.moe.num_experts, cfg.moe.top_k
            dropped = [int((torch.bincount(r.reshape(-1), minlength=X) - C)
                           .clamp(min=0).sum()) for r in routes]
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            logits = tfm.serve_prefill(params, cfg, tokens)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t
        check(logits.shape == (B, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()), f"lm_moe {arch} prefill")
        rec["prefill"] = {
            "B": B, "S": S, "wall_s": wall, "tokens_per_s": B * S / wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "capacity": C, "capacity_factor": cfg.moe.capacity_factor,
            "dropped_share_by_layer": [x / (B * S * k) for x in dropped]}
        del params, tokens, logits, routes
        free_card(device)
        emit({"phase": "lm_moe", **rec, "serve": serve,
              "logits_rel": ZOO_LOGITS_REL,
              "routing_agree_min": MOE_ROUTING_AGREE})
    return arctic


def train_grads_hold(got, want, what: str) -> float:
    """Each gradient leaf within 1e-4 x max|want| + 1e-6 (float32, the
    tolerance of the CPU tests against the JAX package); returns the
    largest error as a share of its limit."""
    worst = 0.0
    for (name, g), w in zip(got, want):
        lim = 1e-4 * float(w.abs().max()) + 1e-6 if w.numel() else 1.0
        err = float((g.float() - w.float()).abs().max()) if w.numel() else 0
        check(err <= lim, f"{what}: gradient {name} off by {err} > {lim}")
        worst = max(worst, err / lim)
    return worst


def timed_train_steps(device, fn, params, state, batches) -> tuple:
    """``fn`` over ``batches`` (argument tuples), each step ending in a
    sync: (params, state, losses, ms a step, peak device memory)."""
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    losses, ms = [], []
    for args in batches:
        t = time.perf_counter()
        params, state, loss = fn(params, state, *args)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        check(np.isfinite(losses[-1]), f"train: loss {losses[-1]}")
    return params, state, losses, ms, torch.cuda.max_memory_allocated(device)


def lm_xent_no_grad(params, cfg, tokens, labels, accum: int) -> float:
    """The mean over ``accum`` microbatches of ``lm_loss`` under no_grad
    (the cache-free forward, its attention in place)."""
    import torch

    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        return float(sum(tfm.lm_loss(params, cfg, t, lab) for t, lab in zip(
            tokens.chunk(accum), labels.chunk(accum))) / accum)


def train_lm(device, arch: str, cfg, shape: tuple, batches, opt) -> dict:
    """``cfg`` at ``shape`` = (B, S) through the port's ``_build_lm`` on
    the cut avals: the steps on ``batches`` (TokenSource steps), timed,
    step 0's loss held to the no-grad forward of its batch."""
    import torch

    from repro_torch.configs.shapes import lm_specs
    from repro_torch.data import TokenSource
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import tree_num_params
    from repro_torch.optim import adamw_init

    B, S = shape
    full = lm_specs(cfg, "train_4k")["tokens"][0]
    avals = {k: ((B, S), torch.int32) for k in ("tokens", "labels")}
    bundle = steps._build_lm(cfg, "train_4k", "train", avals, None, opt,
                             False)
    accum = bundle.static["accum"]
    t = time.perf_counter()
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
    state = adamw_init(params, opt)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t
    src = TokenSource(B, S, cfg.vocab, seed=0)
    args = [tuple(torch.as_tensor(src(i)[k], device=device)
                  for k in ("tokens", "labels")) for i in batches]
    want = lm_xent_no_grad(params, cfg, *args[0], accum)
    params, state, losses, ms, peak = timed_train_steps(
        device, bundle.fn, params, state, args)
    rel = abs(losses[0] - want) / abs(want)
    check(rel <= TRAIN_LOSS_REL, f"train {arch}: step 0 loss {losses[0]} "
          f"against the no-grad forward's {want}")
    if batches[1] == batches[0]:
        check(losses[1] < losses[0], f"train {arch}: the repeated batch's "
              f"loss {losses[1]} did not fall below {losses[0]}")
    steady = ms[1:] if len(ms) > 1 else ms
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": tree_num_params(tfm.lm_param_specs(cfg)),
           "init_s": init_s, "B": B, "S": S, "accum": accum,
           "microbatch": B // accum, "quantize_moments":
           opt.quantize_moments, "lr": opt.lr, "batches": list(batches),
           "losses": losses, "no_grad_loss": want, "loss_rel": rel,
           "ms_per_step": ms, "steady_ms": float(np.mean(steady)),
           "tokens_per_s": B * S / (np.mean(steady) / 1e3),
           "max_memory_allocated": peak,
           "reduced": {"train_4k (B, S)": [list(full), [B, S]]}}
    del params, state, args
    free_card(device)
    return rec


def phase_train(device) -> tuple:
    """Training at full width: MIND's train_batch (the bag kernel forward
    under autograd), Qwen3-0.6B's train_4k and DeepSeek-V3 cut to one
    layer and its MTP module (int8 moments), each through the port's
    train step; a reduced TrainLoop crashed and resumed from its
    checkpoint.  Returns the MIND path's launches (counts set to 0 before
    its steps and read after them) and the bag's figures at the train
    shape for the kernels line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data import RecsysSource
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rec
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoop

    # ---- MIND train_batch at full width
    cfg = get_config("mind")
    B = RECSYS_SHAPES["train_batch"]["batch"]
    bundle = steps.build_step("mind", "train_batch", opt=steps.default_opt(
        cfg, lr=TRAIN_LR))
    params = rec.mind_init(cfg, torch.Generator(device).manual_seed(0))
    state = adamw_init(params, bundle.static["opt"])
    src = RecsysSource(cfg, B, seed=0)
    batches = [({k: torch.as_tensor(v, device=device)
                 for k, v in src(i).items()},)
               for i in range(TRAIN_MIND_STEPS)]
    names = [n for n, _ in tree_leaves(params)]
    loss_k, grads_k = steps.value_and_grad(rec.mind_train_loss, params, cfg,
                                           *batches[0])
    with plain_serving():  # the same step with the bag's plain version
        loss_p, grads_p = steps.value_and_grad(rec.mind_train_loss, params,
                                               cfg, *batches[0])
    loss_err = abs(float(loss_k) - float(loss_p))
    check(loss_err <= 1e-5 * max(1.0, abs(float(loss_p))),
          f"train mind: loss {float(loss_k)} against the plain bag's "
          f"{float(loss_p)}")
    worst = train_grads_hold(list(zip(names, grads_k)), grads_p, "train mind")
    profile_grad = float(grads_k[names.index("profile_embed")].abs().sum())
    check(profile_grad > 0, "train mind: profile_embed got no gradient")
    del grads_k, grads_p
    reset_launch_counts()
    params, state, losses, ms, peak = timed_train_steps(
        device, bundle.fn, params, state, batches)
    launches = {k: v for k, v in launch_counts().items() if v}
    check(launches.get("embedding_bag") == TRAIN_MIND_STEPS,
          f"train mind: {launches} launches, want {TRAIN_MIND_STEPS} of "
          "embedding_bag (one a step's forward)")
    steady = float(np.mean(ms[1:]))
    mind = {"B": B, "steps": TRAIN_MIND_STEPS, "lr": TRAIN_LR,
            "losses": losses, "ms_per_step": ms, "steady_ms": steady,
            "users_per_s": B / (steady / 1e3),
            "max_memory_allocated": peak, "launches": launches,
            "hold": {"loss": float(loss_k), "plain_loss": float(loss_p),
                     "loss_err": loss_err, "worst_grad_share": worst,
                     "profile_embed_grad_abs_sum": profile_grad}}
    # ---- the bag at the train shape: forward kernel, backward plain torch
    table = params["profile_embed"].detach()
    idx = batches[0][0]["profile_ids"].reshape(
        -1, cfg.profile_bag).contiguous()
    Nt, D = table.shape
    Bt, L = idx.shape
    got = ebk.launch_bag(table, idx, None, "mean")
    want = ebk.bag_plain(table, idx, None, "mean")
    err = _close(got, want, (1e-5, 1e-5), "embedding_bag at train_batch")
    g = torch.randn((Bt, D), generator=torch.Generator(device).manual_seed(3),
                    device=device)
    nbytes = 4 * Bt * L + 4 * Bt * D + 4 * Nt * D
    bms, by = bound(nbytes, 2 * Bt * L * D, F32_OPS_PER_S)
    table_r = table.clone().requires_grad_(True)

    def library_fwd_bwd():
        return torch.autograd.grad(F.embedding_bag(idx, table_r, mode="mean"),
                                   table_r, g)

    def port_fwd_bwd():
        return torch.autograd.grad(ebk.embedding_bag(table_r, idx,
                                                     mode="mean"), table_r, g)

    bag_train = {
        "launches": launches.get("embedding_bag", 0), "max_abs_err": err,
        "ms": cuda_ms(lambda: ebk.launch_bag(table, idx, None, "mean"), 20,
                      device),
        "plain_ms": cuda_ms(lambda: ebk.bag_plain(table, idx, None, "mean"),
                            3, device),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.embedding_bag(idx, table,
                                                      mode="mean"), 20,
                              device),
        "backward_ms": cuda_ms(lambda: ebk.bag_backward(
            g, table, idx, None, "mean", False), 5, device),
        "backward_bound_ms": bound(nbytes, 2 * Bt * L * D,
                                   F32_OPS_PER_S)[0],
        "fwd_bwd_ms": cuda_ms(port_fwd_bwd, 5, device),
        "library_fwd_bwd_ms": cuda_ms(library_fwd_bwd, 5, device),
        "shape": {"bags": Bt, "slots": L, "D": D, "rows": Nt,
                  "dtype": "float32", "mode": "mean", "bytes": nbytes}}
    mind["bag_ms"], mind["bag_backward_ms"] = bag_train["ms"], \
        bag_train["backward_ms"]
    del params, state, batches, table, table_r, idx, got, want, g
    free_card(device)
    # ---- Qwen3-0.6B train_4k, batch cut
    cfg = get_config("qwen3-0.6b")
    lm = train_lm(device, "qwen3-0.6b", cfg, TRAIN_LM, TRAIN_LM_BATCHES,
                  steps.default_opt(cfg, lr=TRAIN_LR))
    check(lm["accum"] == 4, f"train qwen3: accum {lm['accum']}, want 4")
    # ---- DeepSeek-V3, its dense layer and MTP module, int8 moments
    base = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(base, n_layers=1, moe=dataclasses.replace(
        base.moe, first_k_dense=1))
    opt = steps.default_opt(cfg)
    check(opt.quantize_moments and cfg.mtp_depth == 1,
          "train deepseek: int8 moments and the MTP module")
    ds = train_lm(device, "deepseek-v3-671b", cfg, TRAIN_DSV3,
                  tuple(range(TRAIN_DSV3_STEPS)), opt)
    ds["reduced"].update({"n_layers": [base.n_layers, cfg.n_layers],
                          "first_k_dense": [base.moe.first_k_dense, 1]})
    # ---- TrainLoop crash and resume (reduced Qwen3-0.6B, float32)
    first, then = TRAIN_RESUME
    with tempfile.TemporaryDirectory(prefix="train_") as tmp:
        kw = dict(reduced=True, log_every=0, device=device)
        a = TrainLoop("qwen3-0.6b", checkpoint_dir=tmp, **kw).run(
            first, resume=False)["losses"]
        b = TrainLoop("qwen3-0.6b", checkpoint_dir=tmp, **kw).run(then)[
            "losses"]
        whole = TrainLoop("qwen3-0.6b", **kw).run(first + then,
                                                  resume=False)["losses"]
    diff = float(np.max(np.abs(np.array(a + b) - whole)))
    check(diff <= TRAIN_RESUME_TOL * max(1.0, float(np.abs(whole).max())),
          f"train: resumed losses {a + b} against {whole}")
    emit({"phase": "train", "mind": mind, "qwen3_0_6b": lm,
          "deepseek_v3": ds,
          "resume": {"steps": [first, then], "losses": a + b,
                     "uninterrupted": whole, "max_abs_diff": diff,
                     "tolerance": TRAIN_RESUME_TOL},
          "tolerances": {"loss_rel": TRAIN_LOSS_REL,
                         "grads": "1e-4 x max|want| + 1e-6"}})
    return launches, bag_train


def sage_ball_seeds(graph, count: int, max_edges: int) -> np.ndarray:
    """``count`` nodes (seeded draw, sorted) with at least one neighbour
    whose two-hop in-neighbourhood (the edges into the node and into each
    of its neighbours) has at most ``max_edges`` edges."""
    deg = np.diff(graph.indptr)
    nbr_deg = np.concatenate([[0], np.cumsum(deg[graph.adj])])
    ball = deg + nbr_deg[graph.indptr[1:]] - nbr_deg[graph.indptr[:-1]]
    cand = np.flatnonzero((deg > 0) & (ball <= max_edges))
    check(len(cand) >= count, f"gnn: {len(cand)} rows with a ball of at "
          f"most {max_edges} edges")
    return np.sort(np.random.default_rng(0).choice(cand, count,
                                                   replace=False))


def sage_logits_f64(params, cfg, graph, x, seeds) -> np.ndarray:
    """GraphSAGE's logits of ``seeds`` in float64 on the host from the CSR
    (mean over each row's neighbours, the layers of ``graphsage_forward``):
    the rows depend only on their two-hop in-neighbourhoods."""
    P = {k: v.detach().double().cpu().numpy()
         for k, v in params.state_dict().items()}
    indptr, adj = graph.indptr, graph.adj

    def layer(i, h_self, h_rows, lens):
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        agg = np.add.reduceat(h_rows, starts, axis=0) / lens[:, None]
        return np.maximum(h_self @ P[f"l{i}.w_self"]
                          + agg @ P[f"l{i}.w_nbr"] + P[f"l{i}.b"], 0.0)

    def h1(nodes):
        nb = [adj[indptr[u]:indptr[u + 1]] for u in nodes]
        return layer(0, x[nodes].astype(np.float64),
                     x[np.concatenate(nb)].astype(np.float64),
                     np.array([len(a) for a in nb]))

    out = []
    for v in seeds:
        nb = adj[indptr[v]:indptr[v + 1]]
        h = h1(np.concatenate([[v], nb]))
        out.append(layer(1, h[:1], h[1:], np.array([len(nb)])))
    return np.concatenate(out) @ P["head"]


class LoadedSource:
    """The step-0 batch and graph a :class:`ChildSource` drew, as a
    full-graph source: the same batch every step."""

    def __init__(self, graph, batch: dict):
        self.graph, self.batch = graph, batch

    def __call__(self, step: int) -> dict:
        return self.batch


def gnn_run(device, run: str, arch: str, shape: str, steps_at,
            drawn: ChildSource | None = None) -> dict:
    """One arch and cell at full width: ``make_source`` (timed: graph draw
    and features; sampling a step; or the child process ``drawn`` of this
    full-graph cell, waited for), ``build_step``'s train step over the
    source's batches at ``steps_at``, each step ending in a sync; step 0's
    loss and gradients held to the same step on the CPU, or, for
    ogb_products, the logits of rows held to a float64 host forward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_init, tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_source

    cfg = get_config(arch)
    bundle = steps.build_step(arch, shape, opt=steps.default_opt(
        cfg, lr=TRAIN_LR))
    N, specs = bundle.static["num_nodes"], bundle.static["pspecs"]
    if drawn is None:
        t = time.perf_counter()
        src = make_source(cfg, shape, False)
        source = {"source_s": time.perf_counter() - t}
    else:
        check(drawn.cell == (arch, shape) and len(set(steps_at)) == 1,
              f"gnn {run}: the child drew {drawn.cell}")
        graph, batch, source = drawn.result()
        src = LoadedSource(graph, batch)
    host, sample_s = {}, []
    for i in steps_at:
        t = time.perf_counter()
        if i not in host:
            host[i] = src(i)
        sample_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    dev = {i: {k: torch.as_tensor(v, device=device) for k, v in b.items()}
           for i, b in host.items()}
    torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t
    params = tree_init(specs, torch.Generator(device).manual_seed(0))
    state = adamw_init(params, bundle.static["opt"])
    b0 = host[steps_at[0]]
    E = int(len(b0["src"]))

    def loss_fn(p, batch):
        return gnn.gnn_loss(p, cfg, {**batch, "num_nodes": N})

    rec = {"run": run, "arch": arch, "cell": shape, "num_nodes": N,
           "edges": E, "params": bundle.num_params, "source_steps":
           list(steps_at), **source, "sample_s": sample_s,
           "upload_s": upload_s, "lr": TRAIN_LR}
    if shape == "ogb_products":
        seeds = sage_ball_seeds(src.graph, GNN_BALL_SEEDS, GNN_BALL_EDGES)
        d0 = dev[steps_at[0]]
        t = time.perf_counter()
        with torch.no_grad():
            got = gnn.graphsage_forward(params, cfg, d0["x"], d0["src"],
                                        d0["dst"], N)[torch.as_tensor(
                                            seeds, device=device)]
        torch.cuda.synchronize(device)
        fwd_s = time.perf_counter() - t
        got = got.double().cpu().numpy()
        want = sage_logits_f64(params, cfg, src.graph, b0["x"], seeds)
        err = float(np.abs(got - want).max())
        lim = GNN_LOGIT_REL * float(np.abs(want).max())
        check(err <= lim, f"gnn {run}: logits of {len(seeds)} rows off the "
              f"float64 host forward by {err} > {lim}")
        deg = np.diff(src.graph.indptr)
        rec["hold"] = {"rows": len(seeds), "max_abs_err": err, "limit": lim,
                       "max_abs_logit": float(np.abs(want).max()),
                       "row_degrees": [int(deg[seeds].min()),
                                       int(deg[seeds].max())],
                       "forward_s": fwd_s}
        del got
    else:
        names = [n for n, _ in tree_leaves(params)]
        loss_k, grads_k = steps.value_and_grad(loss_fn, params,
                                               dev[steps_at[0]])
        cpu = tree_init(specs, torch.Generator().manual_seed(0))
        cpu.load_state_dict(params.state_dict())
        loss_p, grads_p = steps.value_and_grad(
            loss_fn, cpu, {k: torch.as_tensor(v) for k, v in b0.items()})
        rel = abs(float(loss_k) - float(loss_p)) / max(1.0,
                                                       abs(float(loss_p)))
        check(rel <= GNN_LOSS_REL, f"gnn {run}: loss {float(loss_k)} "
              f"against the CPU's {float(loss_p)}")
        worst = train_grads_hold(
            list(zip(names, [g.cpu() for g in grads_k])), grads_p,
            f"gnn {run}")
        rec["hold"] = {"loss": float(loss_k), "cpu_loss": float(loss_p),
                       "loss_rel": rel, "worst_grad_share": worst}
        del grads_k, grads_p, cpu
    reset_launch_counts()
    params, state, losses, ms, peak = timed_train_steps(
        device, bundle.fn, params, state,
        [(dev[i],) for i in steps_at])
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"gnn {run}: kernels launched {launched}")
    if steps_at[0] == steps_at[-1]:
        check(losses[-1] < losses[0], f"gnn {run}: the repeated batch's "
              f"loss {losses[-1]} did not fall below {losses[0]}")
    steady = float(np.mean(ms[1:]))
    rec.update({"losses": losses, "ms_per_step": ms, "steady_ms": steady,
                "edges_per_s": E / (steady / 1e3),
                "max_memory_allocated": peak, "kernels": []})
    del params, state, dev, host, src
    free_card(device)
    return rec


def phase_gnn(device, drawn: ChildSource | None = None) -> dict:
    """The GNN zoo at full width (GNN_RUNS) through build_step and
    make_source (``drawn``: the child drawing GNN_SOURCE_CELL's source;
    None draws it here), then a TrainLoop("gcn-cora", reduced=False)
    crashed and resumed from its checkpoint.  No run launches one of the
    kernels (the reference's GNN reaches no pallas_call): the counts, set
    to 0 before each run's steps, must read 0 after them.  Returns the
    phase's launches (an empty dict)."""
    from repro_torch.train import TrainLoop

    free_card(device)
    t0 = time.perf_counter()
    runs = {}
    for run, arch, shape, steps_at in GNN_RUNS:
        child = drawn if (arch, shape) == GNN_SOURCE_CELL else None
        runs[run] = gnn_run(device, run, arch, shape, steps_at, child)
        emit({"phase": "gnn", **runs[run]})
    first, then = GNN_RESUME
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="gnn_") as tmp:
        kw = dict(reduced=False, log_every=0, device=device)
        a = TrainLoop("gcn-cora", checkpoint_dir=tmp, **kw).run(
            first, resume=False)["losses"]
        b = TrainLoop("gcn-cora", checkpoint_dir=tmp, **kw).run(then)[
            "losses"]
        whole = TrainLoop("gcn-cora", **kw).run(first + then,
                                                resume=False)["losses"]
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"gnn TrainLoop: kernels launched {launched}")
    diff = float(np.max(np.abs(np.array(a + b) - whole)))
    check(diff <= TRAIN_RESUME_TOL * max(1.0, float(np.abs(whole).max())),
          f"gnn: resumed losses {a + b} against {whole}")
    emit({"phase": "gnn", "wall_s": time.perf_counter() - t0,
          "summary": {r: {k: v[k] for k in ("steady_ms", "edges_per_s",
                                             "max_memory_allocated",
                                             "source_s")}
                      for r, v in runs.items()},
          "resume": {"arch": "gcn-cora", "steps": [first, then],
                     "losses": a + b, "uninterrupted": whole,
                     "max_abs_diff": diff, "tolerance": TRAIN_RESUME_TOL},
          "tolerances": {"loss_rel": GNN_LOSS_REL,
                         "grads": "1e-4 x max|cpu| + 1e-6",
                         "logits": f"{GNN_LOGIT_REL} x max|logit| of "
                                   f"{GNN_BALL_SEEDS} rows"}})
    return {}


def bag_entries(device, launches, profile_embed, profile_ids) -> list:
    """The embedding bag at MIND's serve_bulk bags: held to its plain
    version and, bit for bit, to the slot-order sum; timed in turns with
    the kernel of the checkout under ``BASELINE_SRC`` when there is one
    (held to the same sum), and so at the small batches of serve_p99
    (4,096 bags) and retrieval_cand (8 bags), their first bags."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels.ref import embedding_bag_slot_order

    entries = []
    # ---- embedding bag: 2,097,152 bags of 16 slots, D = 64, mean, no weights
    table = profile_embed
    idx = profile_ids.reshape(-1, profile_ids.shape[-1]).contiguous()
    N, D = table.shape
    B, L = idx.shape
    check(bool((idx >= 0).all()), "MIND profile bags hold no masked slot")
    got = ebk.embedding_bag(table, idx, mode="mean")
    want = ebk.embedding_bag_plain(table, idx, mode="mean")
    err = _close(got, want, (1e-5, 1e-5), "embedding_bag at serve_bulk")
    exact = embedding_bag_slot_order(table, idx, "mean")
    check(torch.equal(got, exact), "embedding_bag at serve_bulk != the "
          "slot-order sum bit for bit")
    base = baseline_module("embedding_bag")
    if base is not None:
        check(torch.equal(base.embedding_bag(table, idx, mode="mean"), exact),
              "baseline embedding_bag at serve_bulk != the slot-order sum")
    del exact

    def library():  # one PyTorch call computing the same function here
        return F.embedding_bag(idx, table, mode="mean")

    _close(library(), want, (1e-5, 1e-5), "F.embedding_bag at serve_bulk")

    def in_turns(fn, base_fn, timer, reps) -> tuple:
        """(kernel ms, baseline ms or None), each the least of two runs:
        kernel, baseline, baseline, kernel."""
        ms, base_ms = [timer(fn, reps, device)], []
        if base_fn is not None:
            base_ms = [timer(base_fn, reps, device),
                       timer(base_fn, reps, device)]
        ms.append(timer(fn, reps, device))
        return min(ms), min(base_ms) if base_ms else None

    ms, base_ms = in_turns(
        lambda: ebk.embedding_bag(table, idx, mode="mean"),
        base and (lambda: base.embedding_bag(table, idx, mode="mean")),
        cuda_ms, 20)
    small = {}
    for cell, bags in (("serve_p99", 4096), ("retrieval_cand", 8)):
        part = idx[:bags]
        check(torch.equal(ebk.embedding_bag(table, part, mode="mean"),
                          got[:bags]), f"embedding_bag at {cell}'s {bags} "
              "bags != its rows at serve_bulk")
        k, bk = in_turns(
            lambda: ebk.embedding_bag(table, part, mode="mean"),
            base and (lambda: base.embedding_bag(table, part, mode="mean")),
            device_ms, 200)
        small[cell] = {"bags": bags, "ms": k, "baseline_ms": bk}
    nbytes = 4 * B * L + 4 * B * D + 4 * N * D
    gathered = 4 * B * L * D
    bms, by = bound(nbytes, 2 * B * L * D, F32_OPS_PER_S)
    entries.append({
        "name": "embedding_bag", "route": "cuda", "source": BAG_SOURCE,
        "replaces": BAG_REPLACES, "launches": launches["embedding_bag"],
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(lambda: ebk.embedding_bag_plain(table, idx,
                                                            mode="mean"),
                            3, device),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(library, 20, device),
        "tolerance": [1e-5, 1e-5], "parity": "bit-identical to the "
        "slot-order sum", "baseline_ms": base_ms,
        "baseline_src": None if base is None else str(
            BASELINE_SRC.relative_to(ROOT)),
        "gathered_tb_per_s": gathered / ms / 1e9,
        "plan": ebk.card_plan(table, idx),
        "small_batches": small,
        "shape": {"bags": B, "slots": L, "D": D, "rows": N, "dtype":
                  "float32", "mode": "mean", "bytes": nbytes,
                  "gathered_bytes": gathered}})
    del got, want

    return entries


def device_ms(fn, reps: int, device) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), with the calls queued behind a busy wait on the device first:
    a launch of a few microseconds takes longer to send from the host,
    and :func:`cuda_ms` would time the host."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms at 1.7 GHz: the host queues reps
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def decode_entries(device, launches) -> list:
    """The flash-decode kernels on bf16 caches of Qwen3-0.6B's attention,
    (H, Hkv, d) = (16, 8, 128): at the served shape (one layer of the
    decode_32k cache, 8 x 32768, at cache_len 544, the last served step,
    where every main-path launch runs), held there at the served lengths
    and the split rule's boundaries; and on the full decode_32k and
    long_500k (1 x 524288) caches at cache_len = T; then at the served
    shapes of Qwen3-14B and Arctic (:data:`ZOO_DECODE_SHAPES`).  Times are device
    times (:func:`device_ms`); SDPA is timed on views cut to cache_len,
    which only a caller that knows the length on the host can make."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fdk

    served_len = LM_PROMPT + LM_GENERATE
    gen = torch.Generator(device).manual_seed(5)
    timed, combine = {}, {}
    for label, Bq, T, n, (H, Hkv, d) in (
            *((*shape, DECODE_HEADS) for shape in DECODE_SHAPES),
            *ZOO_DECODE_SHAPES):
        G = H // Hkv
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16) for shape in ((Bq, H, d), (Bq, T, Hkv, d),
                                          (Bq, T, Hkv, d)))
        lens = torch.tensor(n, dtype=torch.int32, device=device)
        if label == "served":
            bounds = [x for b in fdk.split_boundaries(T, Bq, Hkv, G)
                      if b <= served_len for x in (b - 1, b)]
            held = [hold_decode(q, k, v, m, f"flash_decode at {label}")
                    for m in sorted({*DECODE_HELD_LENS, *bounds})]
        else:
            held = [hold_decode(q, k, v, n, f"flash_decode at {label}")]
        err, lim = [(h["max_abs_err"], h["limit"]) for h in held
                    if h["cache_len"] == n][0]
        want = fdk.decode_attention_plain(q, k, v, lens)
        kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)

        def library():  # SDPA, GQA, on the cache views cut to cache_len
            return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                  enable_gqa=True)

        lib_err, lib_lim = bf16_hold(library()[:, :, 0], want, LIBRARY_STEPS)
        check(lib_err <= lib_lim, f"SDPA at {label}: error {lib_err} > "
              f"limit {lib_lim}")
        ml, acc = fdk.launch_split(q, k, v, lens)
        nbytes = 2 * 2 * Bq * n * Hkv * d + 2 * 2 * Bq * H * d
        bms, by = bound(nbytes, 4 * Bq * H * n * d, BF16_OPS_PER_S)
        timed[label] = {
            "max_abs_err": err,
            "ms": device_ms(lambda: fdk.decode_attention(q, k, v, lens), 50,
                            device),
            "split_ms": device_ms(lambda: fdk.launch_split(q, k, v, lens), 50,
                                  device),
            "plain_ms": cuda_ms(lambda: fdk.decode_attention_plain(
                q, k, v, lens), 3, device),
            "bound_ms": bms, "bound_by": by,
            "library_ms": device_ms(library, 50, device),
            "tolerance": "2**-7 * max|want|", "held": held,
            "library_err": lib_err, "library_limit": lib_lim,
            "shape": {"label": label, "B": Bq, "T": T, "cache_len": n,
                      "H": H, "Hkv": Hkv, "d": d, "dtype": "bfloat16",
                      "splits": fdk.split_plan(n, T, Bq, Hkv, G)[2],
                      "bytes": nbytes}}
        # the combine alone, on this split's partials (the splits below n)
        cgot = fdk.launch_combine(ml, acc, lens, T, q.dtype)
        cwant = fdk.combine_plain(ml, acc, lens, T, q.dtype)
        ns = timed[label]["shape"]["splits"]
        cbytes = 4 * Bq * Hkv * ns * G * (d + 2) + 4 + 2 * Bq * H * d
        cbms, cby = bound(cbytes, 3 * Bq * Hkv * ns * G * d, F32_OPS_PER_S)
        cerr, clim = bf16_hold(cgot, cwant)
        check(cerr <= clim, f"combine at {label}: error {cerr} > {clim}")
        combine[label] = {
            "max_abs_err": cerr, "limit": clim,
            "ms": device_ms(lambda: fdk.launch_combine(ml, acc, lens, T,
                                                       q.dtype), 50, device),
            "plain_ms": cuda_ms(lambda: fdk.combine_plain(ml, acc, lens, T,
                                                          q.dtype), 3, device),
            "bound_ms": cbms, "bound_by": cby, "bytes": cbytes}
        timed[label]["combine_ms"] = combine[label]["ms"]
        del q, k, v, kt, vt, ml, acc, want
    served = timed.pop("served")
    return [{
        "name": "flash_decode", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": DECODE_REPLACES, "launches": launches["flash_decode"],
        **served, **timed,
        "note": "top level: the served shape, where every launch ran; ms, "
                "plain_ms, library_ms: the whole function (split + "
                "combine); split_ms, combine_ms: each kernel alone"}, {
        "name": "flash_decode_combine", "route": "cuda",
        "source": DECODE_SOURCE, "replaces": DECODE_REPLACES,
        "launches": launches["flash_decode_combine"],
        **combine.pop("served"), "library_ms": None, **combine,
        "shape": {"partials_of": "flash_decode at each shape"}}]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv: list) -> int:
    if argv[:1] == ["--ooc-build-child"]:
        sys.path.insert(0, str(ROOT / "src"))
        return ooc_build_child(*argv[1:])
    if argv[:1] == ["--gnn-source-child"]:
        sys.path.insert(0, str(ROOT / "src"))
        return gnn_source_child(*argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda", 0)
    # float32 matmuls in full float32 (the MIND checks' tolerance assumes it)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    phase_parity(device)
    small = phase_small(device, *SMALL)
    # the LiveJournal-sized graph, built once for every full-width phase
    t0 = time.perf_counter()
    g = powerlaw_graph(*FULL, device)
    gen_s = time.perf_counter() - t0
    main_path = phase_full(device, g, gen_s)
    launches, r = main_path["launches"], main_path["result"]
    launches.update(phase_per_probe(device, g, r))
    # the out-of-core path's launches, summed over its two decomposes
    outofcore = phase_outofcore(device, g, r, small)
    tables = device_tables(g, device)
    launches.update(phase_segment_sum(device, g, r, tables))
    entries = kernel_entries(g, device, tables, launches, main_path)
    del tables, main_path
    # the maintain path's launches: counts set to 0 before each apply and
    # read after it (timed_apply), summed over the phase
    maintain = phase_maintain(device, g, r)
    # the stream path's launches: writer ingest, replica bootstrap and
    # sync, recovery, each with the counts set to 0 before it
    stream = phase_stream(device, g, r)
    # the shard path's launches: counts set to 0 before each shard run and
    # read after it, summed over the phase
    shard = phase_shard(device, g, r)
    del g, r
    # run c of the gnn phase draws its source on the host meanwhile
    with ChildSource(*GNN_SOURCE_CELL) as drawn:
        bag_launches, profile_embed, profile_ids = phase_mind(device)
        launches.update(bag_launches)
        lm_launches, held = phase_lm(device)
        launches.update(lm_launches)
        # the zoo's paths: Qwen3-14B's decode (lm_prefill, after
        # Qwen3-0.6B's prefill) and Arctic's (lm_moe), each with the counts
        # set to 0 before its generate run
        lm_prefill = phase_lm_prefill(device, held)
        del held
        lm_moe = phase_lm_moe(device)
        # the train path's launches: MIND's five steps, counts set to 0
        # before them
        train, bag_train = phase_train(device)
        # the GNN zoo's runs: counts set to 0 before each run's steps, none
        # of the kernels on its path
        gnn = phase_gnn(device, drawn)
    entries += bag_entries(device, launches, profile_embed, profile_ids)
    next(e for e in entries if e["name"] == "embedding_bag")[
        "train_batch"] = bag_train
    entries += decode_entries(device, launches)
    for entry in entries:
        entry["maintain_launches"] = maintain.get(entry["name"], 0)
        entry["outofcore_launches"] = outofcore.get(entry["name"], 0)
        entry["stream_launches"] = stream.get(entry["name"], 0)
        entry["shard_launches"] = shard.get(entry["name"], 0)
        entry["lm_prefill_launches"] = lm_prefill.get(entry["name"], 0)
        entry["lm_moe_launches"] = lm_moe.get(entry["name"], 0)
        entry["train_launches"] = train.get(entry["name"], 0)
        entry["gnn_launches"] = gnn.get(entry["name"], 0)
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
