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
             reports its sampled peak RSS; both builds start with the
             script and run beside the phases before this one), memmap-
             loaded and held
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
             mixed batch of 100 updates (45% deletes), each applied in
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
  dist       the shard backend over a torch.distributed process group at
             full width on the main path's graph, saved once as CSR files:
             one NCCL rank on cuda:0, then 4 gloo ranks sharing it (NCCL
             refuses two ranks on one device), each rank its own process
             (repro_torch.launch.ranks, this script's dist_rank) that
             memmaps the files and reads only its node range's adjacency;
             decompose(..., "semicore*") on ShardedBackend(group=...),
             distributed_decompose on the group's mesh and a warm_settle,
             every rank equal to the main path's result (the settle to
             "torch"'s) in every field the shard phase holds, every rank
             launching both kernels.  Prints each rank's walls, supersteps,
             the gather's device and host ms a superstep and peak memory
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
  lm_tp      three models at full width under tensor parallelism over
             a (data, model) = (1, 2) mesh of two gloo ranks sharing
             cuda:0 (repro_torch.launch.ranks, this script's tp_rank), in
             one rank start: Qwen3-0.6B (Megatron), DeepSeek-V3 (MLA, its
             dense layer and one MoE layer of 61) and Arctic (one MoE
             layer of 35), experts and MLA's heads over model, each rank
             drawing its pieces leaf by leaf and holding its half of a
             seeded decode_32k cache (8 rows x 32,768 positions; 15.0 GB a
             rank for Qwen3-0.6B): serve_prefill (Qwen3-0.6B 2 x 2,048,
             the MoE models 1 x 4,096), then teacher-forced decode steps
             from len 20,000 (past the piece boundary at 16,384; 4 a
             model) and DeepSeek-V3's long_500k 3
             steps from len 262,142 across its piece boundary, through
             build_step's steps, flash decode on each rank's piece and its
             combine across the ranks in the GQA models; each position's
             joined logits held to a one-device control run first within
             LM_LOGITS_ATOL where its token took the control's experts
             (every position of Qwen3-0.6B, at least MOE_ROUTING_AGREE of
             them), the routes bit for bit the other rank's and at least
             MOE_ROUTING_AGREE the control's; each rank's step ms,
             collectives' time and peak device memory
  tp_serve   four gloo ranks sharing the card on a (data, model) = (2, 2)
             mesh, in one start: long_500k on Qwen3-0.6B at full width
             (28 layers cut to 2), its seeded cache of 524,288 positions
             in four pieces of 131,072 (one a rank: the sequence over
             every axis), three decode steps from len 131,070 across the
             first piece boundary; DeepSeek-V3 at full width with its 256
             experts (its dense layer and one MoE layer of 61) and Arctic
             with its 128 (one MoE layer of 35): the rows over data, the
             capacity counted over both; experts and the attention heads
             over model, the experts' embed pieces left cut over data
             (each rank's partial products move activations; no weight
             gathered, the bytes a MoE call moves recorded beside those
             the join would move), prefill_32k at 2 x 2,048 and four
             decode_32k steps at 8 rows from len 20,000 (Arctic's on
             kernel #5 over each rank's cache piece), each after a warm
             call, held as lm_tp holds them at MOE_HELD_SHARE of the
             positions, the assignments each MoE call dropped
             (moe_apply's count, summed over the data ranks) equal to the
             control's; then MIND at full
             width with its item and profile rows over model: serve_p99
             (512 users), retrieval_cand (one user against 1,000,000
             items, top 100) and serve_bulk (262,144 users cut to
             16,384).  Each rank's joined outputs held to a one-device
             control run first (LM_LOGITS_ATOL; MIND_TOL, retrieval
             indices where the scores are apart); each rank's ms a step
             or a call, its collectives' share, peak device memory and
             kernel launches
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
  tp_train   training over a (data, model) = (1, 2) mesh of two gloo ranks
             sharing the card (this script's tp_train_rank), each held to
             a one-device control run first at the same depth, batch and
             seed: Qwen3-0.6B's train_4k at full width (28 layers cut to
             4, 256 x 4,096 tokens to 2 x 4,096), three steps under
             Megatron tensor parallelism (the vocab-parallel loss, the
             moments kept as model pieces), losses within 2e-3 relative,
             every parameter and moment piece within its stated limit of
             the control's; MIND's train_batch at full width with its rows
             over model (65,536 users cut to 8,192), three steps, saved
             whole after step 1 and restored onto the placements, each
             loss within 1e-4 of the uninterrupted control's, kernel #4
             launched once a step on each rank's row piece and held bit
             for bit to the slot-order sum there; DeepSeek-V3 at full
             width over model (its dense and one MoE layer, 256 routed
             experts cut to 32, MTP, 1 x 4,096, float32 moments), three
             steps, the control's step 0 held to the no-grad forward,
             losses within 2e-3, parameters and moments within their
             stated limits, its whole leaves equal on both ranks and
             step 0's routes the control's at 98% of the positions or
             more.  Each rank prints ms a step, the collectives' share
             and peak device memory.  With --tp-train-witness the phase
             runs alone, DeepSeek-V3's float32 run beside its control
             (tp_train_witness), every moment leaf's distance from both
             printed and the checks reported, not raised
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
on the process-group path (``dist_launches``, every rank's runs),
on Qwen3-14B's decode (``lm_prefill_launches``), on the tensor-parallel
decode (``lm_tp_launches``, both ranks' Qwen3-0.6B steps;
``tp_moe_launches``, both ranks' Arctic decode steps with its experts over
model; kernel #5 also timed at a rank's 16,384-position piece and its
combine over two under ``lm_tp_pieces`` at Qwen3-0.6B's heads and
``tp_moe_pieces`` at Arctic's), on the tp_serve
phase's ranks (``tp_serve_launches``: kernel #5 in long_500k's steps
and in Arctic's decode steps over (2, 2), kernel #4 in MIND's cells;
kernel #5 also timed at one 131,072-position piece a rank and its
combine over four under ``tp_serve_pieces``, at Arctic's heads on a data
rank's 4 rows in two 16,384-position pieces under
``tp_serve_moe_pieces``, kernel #4 at a model rank's row piece under
``tp_serve_local``), on Arctic's
(``lm_moe_launches``), on MIND's train steps (``train_launches``;
the bag's figures at the train shape under ``train_batch``), on the
tp_train phase's ranks (``tp_train_launches``: kernel #4 in MIND's
steps; kernel #4 at a rank's row piece of those bags, with its plain
backward, under ``tp_train_local``) and on the
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

import atexit
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
ARCTIC_HEADS = (56, 8, 128)
ZOO_DECODE_SHAPES = (
    ("served_qwen3_14b", ZOO_SLOTS, ZOO_PROMPT + ZOO_GENERATE,
     ZOO_PROMPT + ZOO_GENERATE, (40, 8, 128)),
    ("served_arctic_480b", ZOO_SLOTS, ZOO_PROMPT + ZOO_GENERATE,
     ZOO_PROMPT + ZOO_GENERATE, ARCTIC_HEADS))
#: lm_tp: three models at full width under tensor parallelism over a
#: (data, model) = TP_MESH mesh of gloo ranks sharing cuda:0 (NCCL refuses
#: two ranks on one card), one rank start for the three (no new process
#: pays a first step's warm-up), each held to a one-device control.  Per
#: model TP_MODELS gives (depth cut (n_layers, first_k_dense) or None,
#: serve_prefill (B, S), decode_32k steps, long_500k steps): Qwen3-0.6B
#: all 28 layers; DeepSeek-V3 (MLA, a shared expert) cut from 61 and 3 to
#: its dense layer and one MoE layer; Arctic (GQA with G = 7, a dense
#: residual MLP) one MoE layer of 35.  The decode steps are teacher-forced
#: at LM_SLOTS rows (cut from 128) over a seeded decode_32k cache of TP_T
#: positions from len TP_LEN0, past the piece boundary at TP_T / 2
#: (Qwen3-0.6B's bf16 cache 30.1 GB whole, 15.0 GB a rank; its steps cut
#: from 8 to 4 to keep the script within its time limit); DeepSeek's
#: long_500k from TP_LONG_LEN0 on a LONG_T latent cache writes on both
#: sides of its piece boundary.  Each rank draws its pieces leaf by leaf
#: (steps.local_init): the whole MoE weights (~28.9 / 28.2 GB) beside a
#: piece on each of two ranks would pass 80 GB
TP_MESH = (1, 2)
TP_T, TP_LEN0 = 32768, 20_000
LONG_T = 524_288
TP_LONG_LEN0 = LONG_T // 2 - 2
TP_TIMEOUT_S = 300
TP_MODELS = {"qwen3-0.6b": (None, (2, 2048), 4, 0),
             "deepseek-v3-671b": ((2, 1), MOE_PREFILL, 4, 3),
             "arctic-480b": ((1, 0), MOE_PREFILL, 4, 0)}
#: tp_serve: four gloo ranks sharing cuda:0 on a (data, model) =
#: TP_SERVE_MESH mesh.  long_500k on Qwen3-0.6B at full width, depth cut
#: from 28 layers to TP_SERVE_LAYERS (its whole bf16 cache is ~60 GB at 28,
#: and the phase holds a one-device control beside the ranks; 4 until the
#: MoE model below came in), its seeded
#: cache of LONG_T positions in four pieces of 131,072 (one a rank),
#: TP_SERVE_STEPS decode steps from len TP_SERVE_LEN0, so they write on
#: both sides of the first piece boundary; then MIND at full width with its
#: rows over model: serve_p99 (512 users), retrieval_cand (one user, every
#: item, top 100) and serve_bulk cut from 262,144 users to TP_SERVE_BULK
#: (its history's all-reduce over model goes through the host)
TP_SERVE_MESH = (2, 2)
TP_SERVE_LAYERS = 2
TP_SERVE_LEN0 = 131_070
TP_SERVE_STEPS = 3
TP_SERVE_BULK = 16_384
#: tp_serve's MoE models over the same mesh, each in lm_tp's form
#: (TP_MODELS), ((n_layers, first_k_dense), serve_prefill (B, S), decode_32k
#: steps): DeepSeek-V3 at full width with all 256 experts (128 a model rank)
#: at its dense layer and one MoE layer of 61, Arctic at full width with its
#: 128 experts (64 a model rank, 6.7 GB of expert pieces a rank) at one MoE
#: layer of 35; the experts' embed dimension stays cut over data, each rank's
#: partial products moving activations (models.moe); prefill_32k cut to 2 x
#: 2,048 (one row a data rank) at the published capacity factor, counted
#: over both rows; decode_32k at LM_SLOTS rows (4 a data rank) from TP_LEN0
#: on the seeded cache of TP_T (its sequence over model; kernel #5 on each
#: rank's piece in Arctic's)
TP_SERVE_MOE = {"deepseek-v3-671b": ((2, 1), (2, 2048), 4),
                "arctic-480b": ((1, 0), (2, 2048), 4)}
#: tp_serve's train case, after the serving cases in the same rank start:
#: Qwen3-0.6B's train_4k at full width (d_model 1,024), 28 layers cut to
#: TP_SERVE_TRAIN_LAYERS and 256 x 4,096 tokens to TP_SERVE_TRAIN_LM (a row
#: a data rank, one microbatch), AdamW at TRAIN_LR, ZeRO-1 as the reference
#: places it: TP_SERVE_TRAIN_STEPS["float32"] steps with float32 moments (a
#: rank's embed slice of its model piece), then ["int8"] steps with int8
#: moments forced (a rank's range of blocks) at eps TP_SERVE_TRAIN_EPS, as
#: tests/test_torch_tp_train.py's EPS (the reference's codec at eps 1e-8
#: turns a decoded v of 0 into a blow-up).  Each run is held to a
#: one-device control at the same depth, batch and seed by tp_train's
#: limits (TP_TRAIN_LOSS_REL, the parameters', TP_TRAIN_MOMENT_REL), and
#: each rank's moment bytes to its placement's share exactly
TP_SERVE_TRAIN_LAYERS = 2
TP_SERVE_TRAIN_LM = (2, 4096)
TP_SERVE_TRAIN_STEPS = {"float32": 3, "int8": 2}
TP_SERVE_TRAIN_EPS = 1e-4
#: the one-device control's retrieval keeps one more than the top 100, so
#: that _retrieval_agrees can tell which neighbours are apart
_TOP_K_HELD = 101
#: kernel #4 timed alone at a model rank's serve_p99 bags: 4,096 bags of
#: 16 slots on one of two row pieces of the profile table (about half the
#: slots masked there)
TP_SERVE_BAGS = (4096, 16, 2)
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
#: the same for a model with a MoE layer: index_add_ adds a token's k
#: gated expert outputs with atomics, in bf16, in an order that changes
#: from run to run, and DeepSeek-V3's MTP logits are not normed (its loss
#: ~84 at tp_train's cut), which carries a bf16 step far: read 2.5e-6 and
#: 1.2e-5 in two runs on an H100
TRAIN_MOE_LOSS_REL = 5e-5
#: the resumed TrainLoop's losses against the uninterrupted run's
#: (float32, the card's atomics reorder sums between runs): relative to
#: max(1, |loss|)
TRAIN_RESUME_TOL = 1e-5
#: tp_train: two gloo ranks sharing cuda:0 on a (data, model) =
#: TP_TRAIN_MESH mesh, each held to a one-device control run first at the
#: same depth, batch and seed (then freed).  Qwen3-0.6B's train_4k at full
#: width, 28 layers cut to TP_TRAIN_LAYERS and the batch from 256 x 4,096
#: to TP_TRAIN_LM (one 8,192-token microbatch); MIND's train_batch at full
#: width with its rows over model, 65,536 users cut to TP_TRAIN_USERS (its
#: history and negatives all-reduces go through the host), saved whole
#: after step 1 and restored onto the placements before step 2.  Each
#: runs TP_TRAIN_STEPS steps at TRAIN_LR, the first a warm-up
TP_TRAIN_MESH = (1, 2)
TP_TRAIN_LAYERS = 4
TP_TRAIN_LM = (2, 4096)
TP_TRAIN_USERS = 8192
TP_TRAIN_STEPS = 3
#: the LM's loss against the control's, relative
TP_TRAIN_LOSS_REL = 2e-3
#: the LM's bf16 parameters against the control's after the steps: an
#: element within 2 x TRAIN_LR a step (AdamW moves it by about lr x
#: sign(g), and a gradient near 0 may turn its sign between the two) plus
#: two bf16 steps of its size; the float32 moments m and v within these
#: shares of their leaf's largest (the control's kept in bf16 to compare)
TP_TRAIN_MOMENT_REL = {"m": 0.05, "v": 0.1}
#: MIND's loss (float32) against the control's: absolute, x max(1, |loss|)
TP_TRAIN_MIND_TOL = 1e-4
#: tp_train's MoE model, DeepSeek-V3 at full width (d_model 7,168, 128
#: heads, its MLA dims, d_ff_expert 2,048, top 8, one shared expert, MTP),
#: ((n_layers, first_k_dense), routed experts, (B, S)): 61 layers cut to
#: its dense layer and one MoE layer, 256 x 4,096 tokens to 1 x 4,096 (one
#: microbatch), and its 256 routed experts to 32, 16 a rank.  One whole
#: MoE layer is 3 x 256 x 7,168 x 2,048 = 11.3e9 parameters: 22.5 GB of
#: bf16 weights, as much again of gradients and of int8 moments, and each
#: leaf's moments decoded whole in float32 in the update, which does not
#: fit in 80 GB beside the one-device control (here ~4.6e9 parameters in
#: all).  Its moments are float32, not the int8 build_step picks at its
#: width: with int8 moments (the reference's AdamW, eps 1e-8) a second
#: moment decodes to 0 where its square is under 1/254 of its block's
#: largest, and the next update divides m by that element's new gradient
#: alone: the control's loss went 83.70, 80.87, 246.92 over three steps and
#: the ranks' 83.70, 80.86, 243.76, 0.64% of parameters past their limit
#: and the moments 12-29 times theirs after the third (an H100, 700 W), and
#: each rank's step joined its pieces' moments whole through the host (63-
#: 74 s a step).  The int8 pieces are held on the CPU
#: (tests/test_torch_tp_moe_train.py).  The control's step 0 is held to
#: the no-grad forward
TP_TRAIN_MOE = ((2, 1), 32, (1, 4096))
#: AdamW's largest move a step in units of lr at the reference's b1 0.9
#: and b2 0.95 over three steps: |m_t| / sqrt(v_t) is at most (1 - b1) /
#: sqrt(1 - b2) x sqrt(sum_k (b1^2 / b2)^k) (Cauchy-Schwarz), and with the
#: bias corrections sqrt(1 - b2^t) / (1 - b1^t) that is 1.0000, 1.0007 and
#: 1.0006 at t = 1, 2, 3.  The MoE model's parameters are held to 2 x this
#: x lr a step plus a bf16 step of their size a step (each run rounds a
#: parameter to bf16 once a step); the LM's limit, 2 x lr a step plus two
#: bf16 steps, read 1.0037 on one of DeepSeek-V3's (an H100)
TP_TRAIN_MOE_MOVE = 1.001
#: the MoE model's float32 moments against the control's: the norm of a
#: leaf's difference over the norm of the control's leaf.  Its largest
#: element cannot be held: MTP's logits are not normed (loss ~84), so a
#: bf16 step flips near-tied logits and 0.46% of the positions take other
#: experts, and an element fed by such a position moves by its own size.
#: A float32 run of the same case sat 0.4201 (m) and 0.4049 (v) of a
#: leaf's largest from the bf16 control, the ranks 0.26-0.48 over runs
#: (chip_smoke.py --tp-train-witness; an H100 at 700 W).  The norm sees a
#: fault in the gradient of a piece whole: one scaled by s moves m by
#: |s - 1| and v by |s^2 - 1|, so a gradient doubled reads 1 and 3, one
#: rank's half of it 0.5 and 0.75.  The reduced config holds every moment
#: within 1e-5 of one device in float32 (tests/test_torch_tp_moe_train.py,
#: the card's test_moe_train_step_over_model_on_the_card)
TP_TRAIN_MOE_MOMENT_REL = {"m": 0.25, "v": 0.5}
#: the least share of a MoE model's positions whose tokens take the
#: control's experts in every MoE layer, over ranks (tp_train's step 0,
#: tp_serve's prefill and decode)
MOE_HELD_SHARE = 0.98
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
# the dist phase: the shard backend over a process group, one NCCL rank on
# cuda:0 and DIST_GLOO_RANKS gloo ranks sharing it (NCCL refuses two ranks
# on one device); this script stops the ranks at DIST_TIMEOUT_S
DIST_GLOO_RANKS = 4
DIST_LAYOUTS = (("nccl_1", "nccl", 1),
                (f"gloo_{DIST_GLOO_RANKS}", "gloo", DIST_GLOO_RANKS))
DIST_TIMEOUT_S = 300
#: the DecompResult fields the dist phase holds (phase_shard's)
DIST_FIELDS = ("iterations", "node_computations", "edge_block_reads",
               "node_table_reads", "updates_per_iter",
               "computations_per_iter")
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


#: (phase, seconds since the script started) of each record emitted
EMITTED: list = []
T_START = time.perf_counter()


def emit(record: dict) -> None:
    EMITTED.append((record.get("phase"), time.perf_counter() - T_START))
    print(json.dumps(record), flush=True)


def phase_walls() -> dict:
    """Each phase's seconds, from the end of the record before it to the
    end of its own, and the script's so far (its time limit is 1,200 s on
    the card)."""
    out, last = [], 0.0
    for phase, t in EMITTED:
        out.append([phase, round(t - last, 1)])
        last = t
    return {"phase": "walls", "script_s": round(last, 1), "seconds": out}


#: a list where a measurement run (``--tp-train-witness``) collects the
#: checks that fail, to print them with its readings; None: they raise
FAILED_CHECKS = None


def check(cond, msg: str) -> None:
    if not cond:
        if FAILED_CHECKS is not None:
            FAILED_CHECKS.append(msg)
            return
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


class ChildBuild:
    """``build_csr`` of the powerlaw stream of ``shape`` (n, draws) into a
    directory of its own (:attr:`path`) by :func:`ooc_build_child`, in a
    process of its own started here; :meth:`result` waits for it and
    returns its JSON record, :meth:`close` (or leaving a ``with`` block, or
    the script's exit) stops it and removes its files."""

    def __init__(self, relabel: str, shape: tuple):
        self.relabel = relabel
        self.tmp = tempfile.TemporaryDirectory(prefix="ooc_")
        self.path = os.path.join(self.tmp.name, relabel)
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ooc-build-child",
             self.path, relabel, str(shape[0]), str(shape[1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(self.close)

    def result(self) -> dict:
        """The child's record, with the parent's wait in ``wait_s``."""
        t = time.perf_counter()
        out, err = self.proc.communicate(timeout=OOC_BUILD_TIMEOUT_S)
        check(self.proc.returncode == 0, f"out-of-core build "
              f"({self.relabel}) failed: {err[-4000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        rec["wait_s"] = time.perf_counter() - t
        return rec

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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


def phase_outofcore(device, g, r, small, builds: tuple) -> dict:
    """The semi-external path: the full phase's stream built out of core
    into on-disk tables (``build_csr`` at the default chunk, in a child
    process, ``builds[0]``, started with the script so that it runs beside
    the phases before this one), memmap-loaded and held array-equal to the
    in-memory graph
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

    legs = (("plain", builds[0], g, r), ("degree", builds[1], *small))
    out = {"phase": "outofcore", "n": g.n, "directed_edges": g.num_directed,
           "relabeled_n": small[0].n,
           "relabeled_directed_edges": small[0].num_directed,
           "builds": {}, "decomposes": {}}
    total: dict = {}
    with builds[0], builds[1]:
        for label, build, base, base_r in legs:
            path, relabel = build.path, build.relabel
            rec = build.result()
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


def time_backend(be, card: bool = True, queue_cycles: int = 0) -> tuple:
    """Wrap the shard backend ``be``'s ``superstep`` and ``gather`` so that
    each call is timed by CUDA events around it (``card``) and by the host
    clock; with ``queue_cycles`` each superstep is queued behind a device
    busy-wait that long, so that its events time its kernels alone.
    Returns the two lists the calls fill, of (event pair or None, host
    seconds); ``del be.superstep, be.gather`` gives back the class's
    methods."""
    import torch

    def timed(store, call, queue=0):
        def wrapped(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(2)] if card else None
            if queue:
                torch.cuda._sleep(queue)
            if card:
                ev[0].record()
            h = time.perf_counter()
            res = call(*a, **kw)
            h = time.perf_counter() - h
            if card:
                ev[1].record()
            store.append((ev, h))
            return res
        return wrapped

    steps, gathers = [], []
    be.superstep = timed(steps, be.superstep, queue_cycles)
    be.gather = timed(gathers, be.gather)
    return steps, gathers


def event_ms(store) -> list:
    """The event times (ms) of the calls :func:`time_backend` recorded."""
    return [ev[0].elapsed_time(ev[1]) for ev, _ in store if ev is not None]


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

    steps, gathers = time_backend(be, queue_cycles=queue_cycles)
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
    gather_ms = event_ms(gathers)
    return res, {
        "wall_s": wall, "supersteps": getattr(res, "iterations", None),
        "supersteps_launched": len(steps),
        "superstep_ms_total": sum(event_ms(steps)),
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


def dist_rank(out_dir: str, graph_dir: str, warm_inserts: str,
              device_type: str) -> None:
    """One rank of the dist phase (started by ``run_ranks``): the graph
    memmapped from ``graph_dir``; ``decompose(..., "semicore*")`` on the
    shard backend over the process group (one shard this rank, on
    ``cuda:(rank % visible cards)``, or the CPU for a rehearsal), its
    supersteps and gathers timed (CUDA events on the card), the kernels'
    launches counted from 0 around it; ``distributed_decompose`` on the
    group's mesh; a ``warm_settle`` from the result plus
    ``warm_inserts``.  Writes ``rank<r>.npz`` (the results' arrays) and
    ``rank<r>.json`` (their fields, walls, launches, timings, peak
    memory)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import HostEngine, ShardedBackend, decompose, \
        warm_settle
    from repro_torch.core.distributed import distributed_decompose
    from repro_torch.graph import CSRGraph
    from repro_torch.kernels import fused_superstep as fsk
    from repro_torch.launch.mesh import make_host_mesh

    rank = dist.get_rank()
    card = device_type == "cuda"
    device = torch.device("cuda", rank % torch.cuda.device_count()) \
        if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    t = time.perf_counter()
    g = CSRGraph.load(graph_dir)
    mesh = make_host_mesh(max_data=None, device=device)
    group = mesh.get_group(mesh.axis_names)
    rec = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(group), "device": str(device),
           "load_s": time.perf_counter() - t}

    def sync():
        if card:
            torch.cuda.synchronize(device)

    def timed_run(fn, be):
        steps, gathers = time_backend(be, card=card)
        sync()
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        fsk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(fsk.LAUNCHES)
        del be.superstep, be.gather  # back to the class's methods
        gather_ms = event_ms(gathers)
        return res, {
            "wall_s": wall, "launches": launches,
            "supersteps": len(steps),
            "superstep_ms_total": sum(event_ms(steps)),
            "gather_ms_per_superstep": sum(gather_ms) / max(1, len(
                gather_ms)),
            "gather_host_ms_per_superstep": 1e3 * sum(h for _, h in gathers)
            / max(1, len(gathers)),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)
            if card else None}

    be = ShardedBackend(group=group, device=device)
    be.retain_structure = True  # read its tables after the run
    r, rec["decompose"] = timed_run(
        lambda: decompose(g, "semicore*", backend=be), be)
    ss = be._resident
    rec["decompose"].update(
        shard_edges=int(sum(t.nbr.shape[0] for t in ss.shards)),
        bounds=[int(x) for x in ss.bounds])
    be.retain_structure = False
    be.unbind()
    t0 = time.perf_counter()
    core, iters = distributed_decompose(g, mesh=mesh)
    sync()
    rec["distributed_decompose"] = {"wall_s": time.perf_counter() - t0,
                                    "iterations": iters}
    wbe = ShardedBackend(group=group, device=device)
    w, rec["warm_settle"] = timed_run(
        lambda: warm_settle(HostEngine(g), r.core, int(warm_inserts), wbe),
        wbe)
    arrays = {"dd_core": core}
    for tag, res in (("cold", r), ("warm", w)):
        arrays[f"{tag}_core"] = res.core
        arrays[f"{tag}_cnt"] = res.cnt
        rec[tag] = _fields(res)
    rec["num_shards"] = int(r.num_shards)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _fields(res) -> dict:
    """A DecompResult's ``DIST_FIELDS`` as plain ints and lists."""
    out = {}
    for f in DIST_FIELDS:
        v = getattr(res, f)
        out[f] = [int(x) for x in v] if isinstance(v, list) else int(v)
    return out


def phase_dist(device, g, r) -> dict:
    """The shard backend over a ``torch.distributed`` process group at full
    width, on the main path's graph ``g`` saved once as CSR files: one
    NCCL rank on cuda:0, then ``DIST_GLOO_RANKS`` gloo ranks sharing it
    (each its own process, started by ``repro_torch.launch.ranks``, each
    memmapping the files and reading only its node range's adjacency).
    Every rank's cold decompose equals the main path's result ``r`` in
    every field ``phase_shard`` holds; ``distributed_decompose`` its core
    and supersteps; its ``warm_settle`` (from ``r``'s core + 1) equals
    the same settle on "torch" (which counts updates as the shard does).
    Every rank must launch both kernels.  Returns the kernels' launches
    summed over every rank's runs."""
    import torch

    from repro_torch.core import HostEngine, TorchBackend, warm_settle
    from repro_torch.launch.ranks import run_ranks

    out = {"phase": "dist", "n": g.n, "directed_edges": g.num_directed}
    total: dict = {}
    t = time.perf_counter()
    want_w = warm_settle(HostEngine(g), r.core, 1, TorchBackend(device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["warm_settle_torch_wall_s"] = time.perf_counter() - t
    want_r, want_wf = _fields(r), _fields(want_w)
    with tempfile.TemporaryDirectory() as tmp:
        graph_dir = os.path.join(tmp, "graph")
        t = time.perf_counter()
        g.save(graph_dir)
        out["save_s"] = time.perf_counter() - t
        for label, backend, world in DIST_LAYOUTS:
            run_dir = os.path.join(tmp, label)
            os.makedirs(run_dir)
            t = time.perf_counter()
            run_ranks("chip_smoke:dist_rank", world, backend=backend,
                      args=[run_dir, graph_dir, 1, device.type],
                      paths=[ROOT],
                      timeout=DIST_TIMEOUT_S, store_dir=tmp)
            ranks = []
            for rank in range(world):
                with open(os.path.join(run_dir, f"rank{rank}.json")) as f:
                    rec = json.load(f)
                with np.load(os.path.join(run_dir, f"rank{rank}.npz")) as z:
                    arrays = {k: z[k] for k in z.files}
                what = f"dist {label} rank {rank}"
                check(rec["backend"] == backend, f"{what}: backend")
                check(np.array_equal(arrays["cold_core"], r.core)
                      and np.array_equal(arrays["cold_cnt"], r.cnt),
                      f"{what}: (core, cnt) != the main path's")
                check(rec["cold"] == want_r, f"{what}: a field != the main "
                      f"path's: {rec['cold']} vs {want_r}")
                check(np.array_equal(arrays["dd_core"], r.core)
                      and rec["distributed_decompose"]["iterations"]
                      == r.iterations, f"{what}: distributed_decompose")
                check(np.array_equal(arrays["warm_core"], want_w.core)
                      and np.array_equal(arrays["warm_cnt"], want_w.cnt),
                      f"{what}: warm settle (core, cnt) != torch's")
                check(rec["warm"] == want_wf,
                      f"{what}: warm settle fields != torch's")
                check(rec["num_shards"] == world, f"{what}: num_shards")
                for run in ("decompose", "warm_settle"):
                    for name in ("row_pass", "push_pass"):
                        n = rec[run]["launches"].get(name, 0)
                        check(n > 0, f"{what}: {name} never launched in "
                              f"the {run}")
                        total[name] = total.get(name, 0) + n
                ranks.append(rec)
            out[label] = {"wall_s": time.perf_counter() - t, "ranks": ranks}
    out["launches"] = dict(total)
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
    step_logits = []  # the kernel path's logits, step by step

    def timed_decode(tokens):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits = decode(tokens)
        e.record()
        events.append((s, e))
        step_logits.append(logits)
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

    # teacher-forced replay: a plain-attention engine on the kernel run's
    # token stream, held step by step to the kernel run's logits (the
    # stream is the tokens that run decoded, so a flipped near-tie cannot
    # fork them); the plain engine's cache ends at the stream's length,
    # which changes no result (positions past len weigh exactly 0)
    with torch.inference_mode():
        stream = torch.as_tensor(np.concatenate([prompts, toks], axis=1),
                                 device=device)
        ep = ServeEngine(params, cfg, LM_SLOTS, steps, device=device)
        worst = torch.zeros((), device=device)
        firm = torch.zeros((), dtype=torch.int64, device=device)
        flips = torch.zeros((), dtype=torch.int64, device=device)
        same_tok = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(steps):
            lk = step_logits[i][:, -1].float()
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
                      "prefill_logits": step_logits[LM_PROMPT - 1]}


class _Routes(list):
    """Each ``moe_apply`` call's routes; ``dropped``, each call's count of
    its tokens' assignments past the capacity (``aux["dropped"]``, as the
    call counted them: over every expert, the ranks before it in the batch
    order counted in); ``kept``, each call's (T, k) experts of its tokens'
    assignments within the capacity (``aux["kept"]``), sorted, -1 for
    each dropped one."""

    def __init__(self):
        super().__init__()
        self.dropped, self.kept = [], []


@contextlib.contextmanager
def recorded_routing():
    """``moe_apply`` as the transformer calls it, each call's routing
    recorded: the top-k expert ids of its tokens (T, k), sorted, as
    ``moe_apply`` draws them from its input and router, and the
    assignments it dropped (:class:`_Routes`)."""
    import torch

    from repro_torch.models import transformer as tfm

    seen, inner = _Routes(), tfm.moe_apply

    def recording(p, cfg, x, *args, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        top = torch.topk(probs, cfg.moe.top_k).indices
        seen.append(top.sort(-1).values)
        aux = {}
        out = inner(p, cfg, x, *args, aux=aux, **kw)
        seen.dropped.append(aux["dropped"])
        seen.kept.append(torch.where(aux["kept"], top, -1).sort(-1).values)
        return out

    tfm.moe_apply = recording
    try:
        yield seen
    finally:
        tfm.moe_apply = inner


@contextlib.contextmanager
def recorded_hidden():
    """``lm_forward`` as the steps call it, each call's hidden states
    (B, S, E) recorded (serve_prefill keeps only the last position's)."""
    from repro_torch.models import transformer as tfm

    seen, inner = [], tfm.lm_forward

    def recording(*args, **kw):
        out = inner(*args, **kw)
        seen.append(out[0])
        return out

    tfm.lm_forward = recording
    try:
        yield seen
    finally:
        tfm.lm_forward = inner


@contextlib.contextmanager
def recorded_traffic(params):
    """Bytes through the port's collectives (``engine._Collectives``)
    while a step runs: ``weight_bytes``, what a rank receives from the
    all-gathers of tensors that share storage with a leaf of ``params`` (a
    weight gathered as it is: serving gathers none), and ``moe``, for each
    MoE call whose experts' embed pieces are cut over the batch axes
    (``models.moe._expert_ffn``): the experts it computed, the
    floating-point bytes this rank received from its all-gathers ((size -
    1) x the input) and put into its all-reduces (the activations), and
    the bytes the join of those experts' three pieces would bring."""
    from repro_torch.core import engine
    from repro_torch.models import moe
    from repro_torch.models.params import tree_leaves

    weights = {t.untyped_storage().data_ptr() for _, t in tree_leaves(params)}
    seen, open_calls = {"weight_bytes": 0, "moe": []}, []
    gather, reduce = engine._Collectives.all_gather, \
        engine._Collectives.all_reduce
    ffn = moe._expert_ffn

    def all_gather(self, x, *a, **kw):
        n = (self.size - 1) * x.numel() * x.element_size()
        if x.untyped_storage().data_ptr() in weights:
            seen["weight_bytes"] += n
        if open_calls and x.is_floating_point():
            open_calls[-1]["activation_bytes"] += n
        return gather(self, x, *a, **kw)

    def all_reduce(self, x, *a, **kw):
        if open_calls and x.is_floating_point():
            open_calls[-1]["activation_bytes"] += x.numel() * x.element_size()
        return reduce(self, x, *a, **kw)

    def expert_ffn(h, p, dp, used):
        if dp is None or p["w_gate"].shape[1] == h.shape[-1]:
            return ffn(h, p, dp, used)
        n = int(used.sum())
        one = sum(p[k][0].numel() * p[k][0].element_size()
                  for k in ("w_gate", "w_up", "w_down"))
        rec = {"experts_used": n, "activation_bytes": 0,
               "join_bytes": (dp.size - 1) * n * one}
        open_calls.append(rec)
        try:
            return ffn(h, p, dp, used)
        finally:
            open_calls.pop()
            seen["moe"].append(rec)

    engine._Collectives.all_gather = all_gather
    engine._Collectives.all_reduce = all_reduce
    moe._expert_ffn = expert_ffn
    try:
        yield seen
    finally:
        engine._Collectives.all_gather = gather
        engine._Collectives.all_reduce = reduce
        moe._expert_ffn = ffn


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


def tp_cache(cfg, B: int, T: int, pieces: int, which, device) -> dict:
    """A seeded decode cache of ``cfg`` (:func:`make_kv_cache_specs`'
    entries: GQA ``k`` and ``v`` (L, B, ·, Hkv, dh), MLA ``ckv`` and
    ``kr`` (L, B, ·, ·)) in ``cfg.dtype``, the pieces ``which`` of
    ``pieces`` along the sequence of T side by side (every piece: the whole
    cache).  Each (entry, layer, piece) is its own seeded draw, so a
    rank's piece equals that slice of the whole."""
    import torch

    from repro_torch.models.transformer import make_kv_cache_specs

    specs = make_kv_cache_specs(cfg, B, T)
    Tp = T // pieces
    out = {}
    for i, key in enumerate(k for k in specs if k != "len"):
        shape, dtype = specs[key]
        t = torch.empty((shape[0], B, Tp * len(which), *shape[3:]),
                        dtype=dtype, device=device)
        for layer in range(shape[0]):
            for j, p in enumerate(which):
                g = torch.Generator(device).manual_seed(
                    (2 * layer + i) * 1000 + p)
                t[layer, :, j * Tp:(j + 1) * Tp] = torch.randn(
                    (B, Tp, *shape[3:]), generator=g, device=device,
                    dtype=dtype)
        out[key] = t
    return out


def _logits_hold(got, want) -> tuple:
    """(max |got - want|, rows whose argmax agree, rows)."""
    got, want = got.float()[:, -1], want.float()[:, -1]
    return (float((got - want).abs().max()),
            int((got.argmax(-1) == want.argmax(-1)).sum()), got.shape[0])


def timed_collectives(sync):
    """Time every collective of the port's process-group paths in this
    process (``engine._Collectives``, the card synchronised by ``sync``
    before and after each); returns a function that gives ``{"calls",
    "s", "bytes"}`` since its last call and starts them again."""
    from repro_torch.core import engine

    coll = {"calls": 0, "s": 0.0, "bytes": 0}

    def timed(fn):
        def collective(self, x, *a, **kw):
            sync()
            t = time.perf_counter()
            y = fn(self, x, *a, **kw)
            sync()
            coll["s"] += time.perf_counter() - t
            coll["calls"] += 1
            coll["bytes"] += x.numel() * x.element_size()
            return y
        return collective

    engine._Collectives.all_gather = timed(engine._Collectives.all_gather)
    engine._Collectives.all_reduce = timed(engine._Collectives.all_reduce)

    def collectives() -> dict:
        out = {"calls": coll["calls"], "s": coll["s"], "bytes": coll["bytes"]}
        coll.update(calls=0, s=0.0, bytes=0)
        return out

    return collectives


def tp_model(arch: str, spec: dict):
    """``arch``'s config as lm_tp runs it, ``(base, cut)``: the depth cut
    to the model's ``depth`` (n_layers, first_k_dense) where it has one."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(arch)
    if spec["reduced"]:
        base = base.reduced()
    depth = spec["models"][arch]["depth"]
    if depth is None:
        return base, base
    return base, dataclasses.replace(base, n_layers=depth[0],
                                     moe=dataclasses.replace(
                                         base.moe, first_k_dense=depth[1]))


def tp_cells(cfg, spec: dict, model: dict, mesh=None) -> dict:
    """The cut config's serve_prefill, decode_32k and (where ``model`` has
    long steps) long_500k steps as ``build_step`` assembles them
    (``_build_lm`` on the cut cells; ``mesh`` its ranks), with each cell's
    tokens (TokenSource, seeds 1, 2, 3), the whole cache's length and
    pieces (decode over ``model``, long_500k over every axis) and its
    starting ``len``: ``{cell: (bundle, tokens, T, pieces, len0)}``, the
    prefill's tokens one (B, S) step, the decode cells' a list of steps."""
    import torch

    from repro_torch.data import TokenSource
    from repro_torch.launch import steps
    from repro_torch.models.transformer import make_kv_cache_specs

    i32 = torch.int32
    B, S = model["prefill"]
    D, M = spec["mesh"]
    out = {"prefill": (steps._build_lm(
        cfg, "prefill_32k", "prefill", {"tokens": ((B, S), i32)}, mesh,
        None, False), [TokenSource(B, S, cfg.vocab, seed=1)(0)["tokens"]],
        None, None, None)}
    cells = [("decode", "decode_32k", spec["slots"], spec["T"], M,
              spec["len0"], model["steps"], 2)]
    if model["long_steps"]:
        cells.append(("long", "long_500k", 1, spec["long"][0], D * M,
                      spec["long"][1], model["long_steps"], 3))
    for cell, shape, rows, T, P, len0, n, seed in cells:
        b = steps._build_lm(cfg, shape, "decode", {
            "tokens": ((rows, 1), i32),
            "caches": make_kv_cache_specs(cfg, rows, T)}, mesh, None, False)
        toks = TokenSource(rows, n, cfg.vocab, seed=seed)(0)["tokens"]
        out[cell] = (b, [toks[:, i:i + 1] for i in range(n)], T, P, len0)
    return out


def tp_reduced(base, cfg, spec: dict, model: dict) -> dict:
    """What lm_tp cut of ``base`` for one model, each as [from, to]."""
    out = {"prefill_32k": [[32, 32768], list(model["prefill"])],
           "decode_32k_batch": [128, spec["slots"]],
           "decode_steps": model["steps"]}
    if cfg is not base:
        out.update(n_layers=[base.n_layers, cfg.n_layers],
                   first_k_dense=[base.moe.first_k_dense,
                                  cfg.moe.first_k_dense])
    return out


def tp_hold(joined, want, routes, ref_routes, rows=slice(None)) -> dict:
    """Joined (B, S, V) logits against the control's ``want``, position by
    position, on this rank's ``rows`` of the batch (``routes``, a
    :class:`_Routes`: its MoE layers' routes of their tokens and the
    experts each kept within the capacity; ``ref_routes`` the control's
    ``(routes, kept)``): the largest |difference| over the positions whose
    tokens took the control's experts and kept the same of them in every
    MoE layer (every position of a model without MoE; a rerouted token
    takes other experts' output, and one rerouted token moves the count
    of its experts, so a token at an expert's capacity may be kept by one
    and dropped by the other: such positions are only counted), how many
    those are, how many took the control's experts (``routed``), the last
    positions' argmax agreement, and the share of (token, MoE layer)
    pairs routed as the control's (None without MoE)."""
    import torch

    joined, want = joined[rows], want[rows]
    B, S = joined.shape[:2]
    first = (rows.start or 0) * S
    routed = torch.ones((B, S), dtype=torch.bool)
    kept = torch.ones((B, S), dtype=torch.bool)
    same = []
    for got, ref, got_kept, ref_kept in zip(routes, ref_routes[0],
                                            routes.kept, ref_routes[1]):
        eq = (got.cpu() == ref[first:first + B * S]).all(-1)
        routed &= eq.reshape(B, S)
        kept &= (got_kept.cpu() == ref_kept[first:first + B * S]).all(
            -1).reshape(B, S)
        same.append(eq)
    held = routed & kept
    want = want.to(joined.device).float()
    err = (joined.float() - want).abs().amax(-1)[held.to(joined.device)]
    return {"err": float(err.max()) if err.numel() else None,
            "held": int(held.sum()), "routed": int(routed.sum()),
            "positions": B * S,
            "argmax_equal": int((joined[:, -1].argmax(-1)
                                 == want[:, -1].argmax(-1)).sum()),
            "routes_alike": float(torch.cat(same).float().mean())
            if same else None}


def tp_control(device, spec: dict, out_dir: str) -> dict:
    """The one-device control of lm_tp, model by model: the whole weights
    drawn from seed 0, serve_prefill (after a warm call on its first 64
    tokens), the decode cells on the whole seeded cache (the ranks' pieces
    side by side; decode_32k after a warm step on a short one), each
    timed, the MoE layers' routes recorded; the logits and routes saved as
    ``ref_<arch>.pt``, the model freed before the next."""
    import torch

    from repro_torch.models import transformer as tfm

    card = device.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(device)

    recs = {}
    for arch, model in spec["models"].items():
        base, cfg = tp_model(arch, spec)
        cells = tp_cells(cfg, spec, model)
        t = time.perf_counter()
        params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
        sync()
        rec = {"init_s": time.perf_counter() - t,
               "reduced": tp_reduced(base, cfg, spec, model)}
        ref = {}
        with torch.inference_mode():
            for cell, (b, toks, T, P, len0) in cells.items():
                toks = [torch.as_tensor(tok, device=device) for tok in toks]
                rows = toks[0].shape[0]
                if cell == "prefill":
                    caches = None
                    b.fn(params, toks[0][:, :64])  # warm
                else:
                    if cell == "decode":  # warm on a short cache
                        warm = tp_cache(cfg, rows, 256, 2, range(2), device)
                        warm["len"] = torch.tensor(5, dtype=torch.int32,
                                                   device=device)
                        b.fn(params, toks[0], warm)
                        del warm
                    caches = tp_cache(cfg, rows, T, P, range(P), device)
                    caches["len"] = torch.tensor(len0, dtype=torch.int32,
                                                 device=device)
                ms, lg, rt, kp, dr = [], [], [], [], []
                for tok in toks:
                    sync()
                    t = time.perf_counter()
                    with recorded_routing() as routes, \
                            recorded_hidden() as hidden:
                        if caches is None:
                            logits = b.fn(params, tok)
                        else:
                            logits, caches = b.fn(params, tok, caches)
                    sync()
                    ms.append(1e3 * (time.perf_counter() - t))
                    if caches is None:  # every position's logits
                        logits = tfm.lm_logits(params, cfg, hidden[0])
                    del hidden
                    check(bool(torch.isfinite(logits).all()),
                          f"lm_tp {arch} control {cell} logits")
                    lg.append(logits.cpu())
                    rt.append([r.cpu() for r in routes])
                    kp.append([r.cpu() for r in routes.kept])
                    dr.append([int(n) for n in routes.dropped])
                ref[cell] = {"logits": lg, "routes": rt, "kept": kp,
                             "dropped": dr}
                rec[f"{cell}_step_ms"] = ms
                rec[f"{cell}_ms_per_step"] = float(np.mean(ms))
                del caches, logits
            del params
        torch.save(ref, os.path.join(out_dir, f"ref_{arch}.pt"))
        if card:
            free_card(device)
        recs[arch] = rec
    return recs


def tp_model_rank(device, mesh, arch: str, spec: dict, run_dir: str,
                  collectives, sync) -> dict:
    """One model of lm_tp on one rank (in :func:`tp_rank`'s start): its
    pieces drawn leaf by leaf (``steps.local_init``: the rank never holds
    the whole model), its cells through the tensor-parallel steps on this
    rank's cache pieces (decode_32k after a warm step on a short cache),
    each step timed with its collectives, the flash-decode launches
    counted from 0 around each decode cell, the MoE layers' routes
    recorded; the joined logits held to the control's (``ref_<arch>.pt``)
    by :func:`tp_hold`.  Writes ``routes_<arch>_<rank>.pt``; returns the
    model's record."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    card = device.type == "cuda"
    _, cfg = tp_model(arch, spec)
    cells = tp_cells(cfg, spec, spec["models"][arch], mesh)
    ref = torch.load(os.path.join(run_dir, f"ref_{arch}.pt"))
    D, d = mesh.axis_size("data"), mesh.axis_index("data")
    if card:
        free_card(device)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = steps.local_init(tfm.lm_param_specs(cfg),
                              cells["prefill"][0].in_shardings[0],
                              torch.Generator(device).manual_seed(0))
    sync()
    rec = {"init_s": time.perf_counter() - t,
           "pieces_bytes": torch.cuda.memory_allocated(device)
           if card else None,
           "draw_peak_bytes": torch.cuda.max_memory_allocated(device)
           if card else None}
    mine = {}
    with torch.inference_mode():
        for cell, (b, toks, T, P, len0) in cells.items():
            # this rank's rows of a batch cut over the data axis (long_500k's
            # one row whole on every rank)
            n = len(toks[0]) // D if cell != "long" else len(toks[0])
            rows = slice(d * n, (d + 1) * n) if cell != "long" else \
                slice(None)
            toks = [torch.as_tensor(tok[rows], device=device) for tok in toks]
            join = b if cell == "prefill" else dataclasses.replace(
                b, out_shardings=b.out_shardings[0])
            c = {"rows": n, "tokens_a_step": toks[0].numel()}
            if cell == "prefill":
                caches = None
                b.fn(params, toks[0][:, :64])  # warm
            else:
                axes = ("data", "model") if cell == "long" else "model"
                index = mesh.axis_index(axes)
                if cell == "decode":  # warm on a short cache
                    warm = tp_cache(cfg, n, 128 * P, P, [index], device)
                    warm["len"] = torch.tensor(5, dtype=torch.int32,
                                               device=device)
                    b.fn(params, toks[0], warm)
                    del warm
                caches = {k: v[:, rows].contiguous() for k, v in tp_cache(
                    cfg, n * (D if cell != "long" else 1), T, P, [index],
                    device).items()}
                c.update(T=T, pieces=P, len0=len0, cache_piece_bytes=sum(
                    x.numel() * x.element_size() for x in caches.values()))
                caches["len"] = torch.tensor(len0, dtype=torch.int32,
                                             device=device)
            sync()
            collectives()
            fdk.reset_launch_counts()
            ms, holds, coll = [], [], {"s": 0.0, "calls": 0, "bytes": 0}
            mine[cell], dropped, weight_bytes, moe_calls = [], [], 0, []
            for i, tok in enumerate(toks):
                sync()
                t = time.perf_counter()
                with recorded_routing() as routes, \
                        recorded_hidden() as hidden, \
                        recorded_traffic(params) as traffic:
                    if caches is None:
                        logits = b.fn(params, tok)
                    else:
                        logits, caches = b.fn(params, tok, caches)
                sync()
                ms.append(1e3 * (time.perf_counter() - t))
                for k, v in collectives().items():
                    coll[k] += v
                if caches is None:  # every position's logits, vocab piece
                    logits = tfm.lm_logits(params, cfg, hidden[0])
                del hidden
                joined = steps.gather_outputs(join, logits)
                collectives()
                check(bool(torch.isfinite(joined).all()),
                      f"lm_tp {arch} rank {mesh.rank} {cell} logits")
                holds.append(tp_hold(joined, ref[cell]["logits"][i], routes,
                                     (ref[cell]["routes"][i],
                                      ref[cell]["kept"][i]), rows))
                mine[cell].append([r.cpu() for r in routes])
                dropped.append([int(n) for n in routes.dropped])
                weight_bytes += traffic["weight_bytes"]
                moe_calls += traffic["moe"]
                del joined
            alike = [h["routes_alike"] for h in holds
                     if h["routes_alike"] is not None]
            c.update(
                steps=len(toks), step_ms=ms, ms_per_step=float(np.mean(ms)),
                tokens_per_s=1e3 * c["tokens_a_step"] * len(ms) / sum(ms),
                collective_ms_per_step=1e3 * coll["s"] / len(ms),
                collective_share=1e3 * coll["s"] / sum(ms),
                collective_calls=coll["calls"],
                collective_bytes=coll["bytes"],
                logits_piece=list(logits.shape),
                max_abs_logit_err=[h["err"] for h in holds],
                positions=sum(h["positions"] for h in holds),
                positions_held=sum(h["held"] for h in holds),
                positions_routed=sum(h["routed"] for h in holds),
                argmax_equal=sum(h["argmax_equal"] for h in holds),
                routing_agree_share=min(alike) if alike else None,
                dropped=dropped, launches=dict(fdk.LAUNCHES),
                weight_bytes_gathered=weight_bytes, moe_calls=moe_calls)
            if caches is not None:
                c["len_after"] = int(caches["len"])
            rec[cell] = c
            del caches, logits
        rec["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(device) if card else None
        del params
    torch.save(mine, os.path.join(run_dir, f"routes_{arch}_{mesh.rank}.pt"))
    if card:
        free_card(device)
    return rec


def tp_rank(run_dir: str, device_type: str) -> None:
    """One rank of the lm_tp phase (started by ``run_ranks``): the mesh
    ``spec["mesh"]`` over the group, on ``cuda:(rank % visible cards)``
    (or the CPU for a rehearsal), the collectives timed (the card
    synchronised before and after each); each model of ``spec["models"]``
    in turn (:func:`tp_model_rank`).  Writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, _device_mesh

    rank = dist.get_rank()
    card = device_type == "cuda"
    device = torch.device("cuda", rank % torch.cuda.device_count()) \
        if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    with open(os.path.join(run_dir, "spec.json")) as f:
        spec = json.load(f)
    shape, axes = tuple(spec["mesh"]), ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    rec = {"rank": rank, "coords": mesh.coords(),
           "backend": dist.get_backend(), "device": str(device)}

    def sync():
        if card:
            torch.cuda.synchronize(device)

    collectives = timed_collectives(sync)
    rec["models"] = {arch: tp_model_rank(device, mesh, arch, spec, run_dir,
                                         collectives, sync)
                     for arch in spec["models"]}
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def tp_spec() -> dict:
    """The lm_tp phase at full width (:data:`TP_MODELS`)."""
    return {"reduced": False, "mesh": list(TP_MESH), "slots": LM_SLOTS,
            "T": TP_T, "len0": TP_LEN0, "long": [LONG_T, TP_LONG_LEN0],
            "models": {arch: {"depth": depth, "prefill": list(prefill),
                              "steps": n, "long_steps": n_long}
                       for arch, (depth, prefill, n, n_long)
                       in TP_MODELS.items()}}


def phase_lm_tp(device, spec: dict | None = None) -> tuple:
    """Qwen3-0.6B, DeepSeek-V3 and Arctic (:data:`TP_MODELS`) under tensor
    parallelism at full width: the one-device control first
    (:func:`tp_control`), then :data:`TP_MESH`'s ranks (:func:`tp_rank`,
    gloo, sharing the card, one start for the three), each holding its
    joined logits to the control's within :data:`LM_LOGITS_ATOL` at the
    positions routed as the control's (every position of Qwen3-0.6B; at
    least :data:`MOE_ROUTING_AGREE` of them), its MoE routes bit for bit
    the other rank's and at least :data:`MOE_ROUTING_AGREE` the control's,
    and launching both flash-decode kernels once a layer a step of a GQA
    model's decode (none in DeepSeek-V3's latent decode).  Returns the
    kernels' launches summed over the ranks' decode steps of the models
    without MoE, and of those with it."""
    from repro_torch.launch.ranks import run_ranks

    spec = spec or tp_spec()
    if device.type == "cuda":
        free_card(device)
    out = {"phase": "lm_tp", **spec, "logits_atol": LM_LOGITS_ATOL,
           "routing_agree": MOE_ROUTING_AGREE,
           "reduced": {"qwen3-0.6b_decode_steps": [8, 4]}}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out["control"] = tp_control(device, spec, tmp)
        out["control_wall_s"] = time.perf_counter() - t
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        world = spec["mesh"][0] * spec["mesh"][1]
        t = time.perf_counter()
        run_ranks("chip_smoke:tp_rank", world, backend="gloo",
                  args=[tmp, device.type], paths=[ROOT],
                  timeout=TP_TIMEOUT_S, store_dir=tmp)
        out["ranks_wall_s"] = time.perf_counter() - t
        ranks = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                rec = json.load(f)
            check(rec["backend"] == "gloo", f"lm_tp rank {rank}: backend")
            ranks.append(rec)
        dense, moe = check_tp(spec, tmp, ranks)
    out.update(ranks=ranks, launches=dense, moe_launches=moe)
    emit(out)
    return dense, moe


def check_tp(spec: dict, run_dir: str, ranks: list, phase: str = "lm_tp",
             held_share: float = MOE_ROUTING_AGREE) -> tuple:
    """lm_tp's checks of the ranks' records (:func:`tp_model_rank`)
    against the control (at least ``held_share`` of a MoE model's
    positions held); returns kernel #5's launches summed over the ranks'
    decode steps of the models without MoE, and of those with it."""
    import torch

    dense, moe = {}, {}
    for arch in spec["models"]:
        _, cfg = tp_model(arch, spec)
        mine = []
        for r in range(len(ranks)):
            cells = torch.load(os.path.join(run_dir, f"routes_{arch}_{r}.pt"))
            mine.append([t for cell in sorted(cells) for step in cells[cell]
                         for t in step])
        for r, got in enumerate(mine):
            # the ranks that hold the same rows: the same data coordinate
            peer = next(q for q, rank in enumerate(ranks) if rank["coords"][
                "data"] == ranks[r]["coords"]["data"])
            check(len(got) == len(mine[peer]) and all(
                torch.equal(a, b) for a, b in zip(got, mine[peer])),
                f"{phase} {arch} rank {r}: routes differ from rank {peer}'s")
        check((len(mine[0]) > 0) == (cfg.moe is not None),
              f"{phase} {arch}: {len(mine[0])} routings recorded")
        total = moe if cfg.moe is not None else dense
        for r, rank in enumerate(ranks):
            rec, what = rank["models"][arch], f"{phase} {arch} rank {r}"
            for cell in ("prefill", "decode", "long"):
                if cell not in rec:
                    continue
                c = rec[cell]
                least = c["positions"] if cfg.moe is None else \
                    held_share * c["positions"]
                check(c["positions_held"] >= least, f"{what}: {cell} held "
                      f"{c['positions_held']} of {c['positions']} positions "
                      f"(routed as the control's), fewer than {least}")
                errs = [e for e in c["max_abs_logit_err"] if e is not None]
                worst = max(errs) if errs else float("inf")
                check(worst <= LM_LOGITS_ATOL, f"{what}: {cell} logits "
                      f"differ from the control's by {worst} > "
                      f"{LM_LOGITS_ATOL}")
                check(c["weight_bytes_gathered"] == 0, f"{what}: {cell} "
                      f"gathered {c['weight_bytes_gathered']} weight bytes")
                if cfg.moe is not None and spec["mesh"][0] > 1:
                    # the pieces' partial products: every MoE call, each
                    # moving less than the join of its experts would
                    calls = c["moe_calls"]
                    want = c["steps"] * (cfg.n_layers
                                         - cfg.moe.first_k_dense)
                    check(len(calls) == want, f"{what}: {cell} ran "
                          f"{len(calls)} MoE calls on pieces, not {want}")
                    for call in calls:
                        check(call["activation_bytes"] < call["join_bytes"]
                              or not call["experts_used"], f"{what}: "
                              f"{cell} moved {call}")
                if cfg.moe is not None:
                    check(c["routing_agree_share"] >= held_share,
                          f"{what}: {cell} routes "
                          f"{c['routing_agree_share']} of the pairs as the "
                          "control")
                if cell == "prefill":
                    continue
                check(c["len_after"] == c["len0"] + c["steps"],
                      f"{what}: {cell} len")
                layers = cfg.n_layers if cfg.mla is None else 0
                for name in ("flash_decode", "flash_decode_combine"):
                    n = c["launches"].get(name, 0)
                    check(n == c["steps"] * layers, f"{what}: {cell} {name} "
                          f"launched {n} times, not {c['steps']} steps x "
                          f"{layers} layers")
                    if layers:
                        total[name] = total.get(name, 0) + n
    return dense, moe


def moe_drops(spec: dict, run_dir: str, ranks: list) -> dict:
    """Each MoE model's dropped (token, expert) assignments a MoE call
    (``moe_apply``'s ``aux["dropped"]``, as each call counted them), the
    control's and the ranks': each rank's count over every expert of its
    rows' assignments past the global capacity, equal on every model rank
    of a data rank, summed over the data ranks.  Equal to the control's
    where every token took the control's experts; a rerouted token moves
    k assignments, each of which can move the count by 2, so the two may
    differ by 2k a rerouted token."""
    import torch

    out = {}
    for arch in spec["models"]:
        _, cfg = tp_model(arch, spec)
        if cfg.moe is None:
            continue
        k = cfg.moe.top_k
        ref = torch.load(os.path.join(run_dir, f"ref_{arch}.pt"))
        by_data = {}
        for r in ranks:
            by_data.setdefault(r["coords"]["data"], []).append(r)
        rec = {}
        for cell in ("prefill", "decode"):
            if cell not in ref:
                continue
            rows = []
            for d, group in by_data.items():
                first = group[0]["models"][arch][cell]["dropped"]
                for r in group[1:]:
                    check(r["models"][arch][cell]["dropped"] == first,
                          f"tp_serve {arch} {cell}: data rank {d}'s model "
                          f"ranks count {r['models'][arch][cell]['dropped']}"
                          f" dropped assignments, not {first}")
            got = [g[0]["models"][arch][cell]["dropped"]
                   for _, g in sorted(by_data.items())]
            order = sorted(range(len(ranks)), key=lambda r: (
                ranks[r]["coords"]["data"], ranks[r]["coords"]["model"]))
            routes = [torch.load(os.path.join(run_dir,
                                              f"routes_{arch}_{r}.pt"))
                      for r in order if ranks[r]["coords"]["model"] == 0]
            for i, want_step in enumerate(ref[cell]["routes"]):
                for layer, want in enumerate(want_step):
                    joined = torch.cat([g[cell][i][layer] for g in routes])
                    rerouted = int((~(joined == want).all(-1)).sum())
                    drops = [ref[cell]["dropped"][i][layer],
                             sum(g[i][layer] for g in got)]
                    check(abs(drops[0] - drops[1]) <= 2 * k * rerouted,
                          f"tp_serve {arch} {cell} step {i} layer {layer}: "
                          f"the ranks drop {drops[1]} assignments, the "
                          f"control {drops[0]}, {rerouted} tokens rerouted")
                    rows.append({"step": i, "layer": layer,
                                 "control": drops[0], "ranks": drops[1],
                                 "per_data_rank": [g[i][layer] for g in got],
                                 "rerouted": rerouted})
            rec[cell] = rows
        out[arch] = rec
    return out


def tp_serve_lm(spec: dict, device) -> tuple:
    """``(cfg, whole params, decode tokens, step builder)`` of the
    tp_serve phase's long_500k run (the weights drawn from seed 0)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tfm

    cfg = get_config(spec["arch"])
    if spec["reduced"]:
        cfg = cfg.reduced()
    if spec["layers"]:
        cfg = replace(cfg, n_layers=spec["layers"])
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
    steps = TokenSource(1, spec["steps"], cfg.vocab, seed=4)(0)["tokens"]
    decode = [torch.as_tensor(steps[:, i:i + 1], device=device)
              for i in range(spec["steps"])]

    def build(mesh=None):
        return build_step(spec["arch"], "long_500k", mesh,
                          reduced=spec["reduced"],
                          depth_override=spec["layers"])

    return cfg, params, decode, build


def tp_serve_mind(spec: dict, device) -> tuple:
    """``(cfg, whole params, batches)`` of the tp_serve phase's MIND cells
    (the weights drawn from seed 0, the batches host tensors; retrieval's
    users as many as its cell's specs give, its candidates every item)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.data import RecsysSource
    from repro_torch.models import recsys as rec

    cfg = get_config("mind")
    if spec["reduced"]:
        cfg = cfg.reduced()
    params = rec.mind_init(cfg, torch.Generator(device).manual_seed(0))
    _, av = input_specs(cfg, "retrieval_cand", reduced=spec["reduced"])
    batches = {}
    for cell, users, seed in (("serve_p99", spec["p99"], 1),
                              ("serve_bulk", spec["bulk"], 3),
                              ("retrieval_cand", av["hist_ids"][0][0], 5)):
        b = RecsysSource(cfg, users, seed=seed)(0)
        b = {k: torch.as_tensor(b[k]) for k in ("hist_ids", "profile_ids")}
        if cell == "retrieval_cand":
            b["candidate_ids"] = torch.arange(cfg.n_items, dtype=torch.int32)
        batches[cell] = b
    return cfg, params, batches


def tp_serve_rank(run_dir: str, device_type: str) -> None:
    """One rank of the tp_serve phase (started by ``run_ranks``): the mesh
    ``spec["mesh"]`` over the group on ``cuda:(rank % visible cards)`` (or
    the CPU for a rehearsal).  long_500k: this rank's weight pieces cut
    from the whole, its seeded piece of the cache's sequence (piece
    ``axis_index(("data", "model"))``), the decode steps through
    ``build_step``'s step, each timed, their joined logits held to the
    one-device control's (``ref.pt``).  The MoE models of ``spec["moe"]``
    (:func:`tp_model_rank`: this rank's rows of each batch, its pieces
    drawn leaf by leaf).  MIND: its rows over model, each cell's batch cut
    to this rank's, the step timed and its joined output held to the
    control's.  Then the train case (:func:`tp_serve_train_rank`).  The
    kernels' launches counted from 0 around each run, the collectives
    timed.  Writes ``rank<r>.json``."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import build_step, gather_outputs, \
        local_args

    rank = dist.get_rank()
    card = device_type == "cuda"
    device = torch.device("cuda", rank % torch.cuda.device_count()) \
        if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    with open(os.path.join(run_dir, "spec.json")) as f:
        spec = json.load(f)
    shape, axes = tuple(spec["mesh"]), ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    P, piece = mesh.size, mesh.axis_index(axes)
    rec = {"rank": rank, "coords": mesh.coords(), "piece": piece,
           "backend": dist.get_backend(), "device": str(device)}

    def sync():
        if card:
            torch.cuda.synchronize(device)

    collectives = timed_collectives(sync)
    ref = torch.load(os.path.join(run_dir, "ref.pt"))
    with torch.inference_mode():
        # ---- long_500k: the cache sequence over all P ranks
        t = time.perf_counter()
        cfg, whole, decode, build = tp_serve_lm(spec, device)
        dec = build(mesh)
        join = replace(dec, out_shardings=dec.out_shardings[0])
        params = local_args(dec, whole)[0]
        del whole
        warm = tp_cache(cfg, 1, 128 * P, P, [piece], device)
        warm["len"] = torch.tensor(5, dtype=torch.int32, device=device)
        dec.fn(params, decode[0], warm)
        del warm
        caches = tp_cache(cfg, 1, spec["T"], P, [piece], device)
        caches["len"] = torch.tensor(spec["len0"], dtype=torch.int32,
                                     device=device)
        sync()
        rec["init_s"] = time.perf_counter() - t
        rec["cache_piece_bytes"] = 2 * caches["k"].numel() * \
            caches["k"].element_size()
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        collectives()
        fdk.reset_launch_counts()
        step_ms, errs, agree, coll_s = [], [], 0, 0.0
        for i, tok in enumerate(decode):
            sync()
            t = time.perf_counter()
            logits, caches = dec.fn(params, tok, caches)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t))
            coll_s += collectives()["s"]
            e, a, _ = _logits_hold(gather_outputs(join, logits),
                                   ref["long_500k"][i].to(device))
            collectives()
            errs.append(e)
            agree += a
        rec["long_500k"] = {
            "T": spec["T"], "T_piece": caches["k"].shape[2],
            "len0": spec["len0"], "layers": cfg.n_layers,
            "steps": len(decode), "step_ms": step_ms,
            "ms_per_step": float(np.mean(step_ms)),
            "collective_ms_per_step": 1e3 * coll_s / len(decode),
            "collective_share": 1e3 * coll_s / sum(step_ms),
            "logits_piece": list(logits.shape), "max_abs_logit_err": errs,
            "argmax_equal": agree, "rows": len(decode),
            "len_after": int(caches["len"]), "launches": dict(fdk.LAUNCHES),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)
            if card else None}
        del params, caches, logits
        if card:
            free_card(device)
    # ---- the MoE models: rows over data, experts and heads over model
    if spec.get("moe"):
        rec["models"] = {arch: tp_model_rank(device, mesh, arch, spec["moe"],
                                             run_dir, collectives, sync)
                         for arch in spec["moe"]["models"]}
    with torch.inference_mode():
        # ---- MIND: item and profile rows over model
        t = time.perf_counter()
        mcfg, whole, batches = tp_serve_mind(spec, device)
        cells = {c: build_step("mind", c, mesh, reduced=spec["reduced"])
                 for c in batches}
        params = local_args(cells["serve_p99"], whole)[0]
        del whole
        local = {c: local_args(cells[c], None, {
            k: v.to(device) for k, v in batches[c].items()})[1]
            for c in batches}
        for cell, b in cells.items():  # warm
            b.fn(params, local[cell])
        sync()
        rec["mind_init_s"] = time.perf_counter() - t
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        rec["mind"] = {}
        for cell in ("serve_p99", "retrieval_cand", "serve_bulk"):
            b = cells[cell]
            collectives()
            ebk.reset_launch_counts()
            sync()
            t = time.perf_counter()
            out = b.fn(params, local[cell])
            sync()
            wall = time.perf_counter() - t
            c = collectives()
            r = {"users": batches[cell]["hist_ids"].shape[0],
                 "wall_ms": 1e3 * wall, "collective_ms": 1e3 * c["s"],
                 "collective_share": c["s"] / wall,
                 "collective_calls": c["calls"],
                 "collective_bytes": c["bytes"],
                 "launches": dict(ebk.LAUNCHES)}
            if cell == "retrieval_cand":
                vals, idx = out
                want_v, want_i = (x.to(device) for x in ref[cell])
                r["indices_held_equal"] = _retrieval_agrees(
                    vals, idx, want_v, want_i, MIND_TOL)
                r["max_abs_err"] = float(
                    (vals - want_v[..., :vals.shape[-1]]).abs().max())
            else:
                got = gather_outputs(b, out)
                r["max_abs_err"] = _close(got, ref[cell].to(device),
                                          MIND_TOL, f"tp_serve {cell} "
                                          f"rank {rank}")
                r["out_piece"] = list(out.shape)
            collectives()
            rec["mind"][cell] = r
        ebk.raise_bad_index(device)
        rec["mind_max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device) if card else None
        del params, local
    if card:
        free_card(device)
    # ---- Qwen3-0.6B training: ZeRO-1 over data, Megatron over model
    if spec.get("train"):
        rec["train"] = tp_serve_train_rank(device, mesh, spec, run_dir,
                                           collectives, sync)
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def tp_serve_train_build(spec: dict, kind: str, mesh=None) -> tuple:
    """``(cfg, bundle, batches)`` of tp_serve's train case with ``kind``
    ("float32" or "int8") moments on ``mesh`` (None: one device): the LM
    cut to ``spec["train"]``'s layers, its train step on the cut ``lm``
    (B, S) avals (one microbatch), one ``TokenSource`` batch a step (seed
    0, host tensors)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.launch import steps

    t = spec["train"]
    cfg = get_config(t["arch"])
    if spec["reduced"]:
        cfg = cfg.reduced()
    cfg = replace(cfg, n_layers=t["layers"])
    q8 = kind == "int8"
    opt = steps.default_opt(cfg, quantize_moments=q8, lr=t["lr"],
                            **({"eps": t["eps"]} if q8 else {}))
    B, S = t["lm"]
    avals = {k: ((B, S), torch.int32) for k in ("tokens", "labels")}
    b = steps._build_lm(cfg, "train_4k", "train", avals, mesh, opt, False)
    tok = TokenSource(B, S, cfg.vocab, seed=0)
    batches = [tuple(torch.as_tensor(tok(i)[k]) for k in ("tokens", "labels"))
               for i in range(t["steps"][kind])]
    return cfg, b, batches


def local_state(b, device) -> dict:
    """This rank's pieces of fresh AdamW state for ``b``'s parameters, as
    ``b.in_shardings[1]`` places them (ZeRO-1): each leaf's moments made
    whole and cut at once."""
    import torch

    from repro_torch.launch.steps import _piece, _zip_map
    from repro_torch.optim import adamw_init

    opt = b.static["opt"]

    def one(spec, sh):
        whole = adamw_init({"w": torch.empty(spec.shape, dtype=spec.dtype,
                                             device=device)}, opt)["mu"]["w"]
        return {k: _piece(v, sh[k]) for k, v in whole.items()}

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": _zip_map(one, b.static["pspecs"], b.in_shardings[1]["mu"])}


def share_sizes(b) -> tuple:
    """``(bytes, limits)`` of this rank's ZeRO-1 share of ``b``'s moments
    (``in_shardings[1]``): the bytes of its pieces, and leaf name -> the
    most elements a moment tensor of its share may hold in the update (its
    float32 moments' piece, or its range of int8 blocks and one block's
    padding)."""
    from repro_torch.models.params import tree_leaves

    sh = dict(tree_leaves(b.in_shardings[1]["mu"]))
    nbytes, limits = 0, {}
    for name, (shape, dtype) in tree_leaves(b.args[1]["mu"]):
        leaf, key = name.rsplit(".", 1)
        n = int(np.prod(shape)) // sh[name].frac
        nbytes += n * dtype.itemsize
        if key == "m":
            limits[leaf] = n
        elif key == "m_q":
            limits[leaf] = n + shape[1]
    return nbytes, limits


@contextlib.contextmanager
def recorded_moments(state):
    """Leaf name -> the most elements of a moment tensor formed in
    ``optim.adamw_update`` while the block runs (what ``q8_decode``
    returns, what ``q8_encode`` is given, the float32 m and v it
    updates), for the leaves of ``state``'s moments."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import optimizer as opt

    leaf_of = {t.untyped_storage().data_ptr(): n.rsplit(".", 1)[0]
               for n, t in tree_leaves(state["mu"])}
    seen, now = {}, [None]
    orig = {k: getattr(opt, k)
            for k in ("_update_leaf", "q8_decode", "q8_encode")}

    def note(*xs):
        seen[now[0]] = max(seen.get(now[0], 0), *(x.numel() for x in xs))

    def update_leaf(p, g, mu, *a, **kw):
        now[0] = leaf_of.get(next(iter(mu.values())).untyped_storage()
                             .data_ptr())
        if "m" in mu:  # float32 moments: updated as they are
            note(mu["m"], mu["v"])
        return orig["_update_leaf"](p, g, mu, *a, **kw)

    def decode(*a, **kw):
        out = orig["q8_decode"](*a, **kw)
        note(out)
        return out

    def encode(x, *a, **kw):
        note(x)
        return orig["q8_encode"](x, *a, **kw)

    opt._update_leaf = update_leaf
    opt.q8_decode, opt.q8_encode = decode, encode
    try:
        yield seen
    finally:
        for k, f in orig.items():
            setattr(opt, k, f)


def tp_serve_train_control(device, spec: dict, out_dir: str) -> dict:
    """The one-device control of tp_serve's train case, each moment kind
    in turn: the whole weights drawn from seed 0, fresh AdamW state, the
    steps timed; the state saved as ``train_<kind>_control.pt`` (float32
    moments in bf16, int8 ones as they are), freed before the next."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init

    card = device.type == "cuda"
    recs = {}
    for kind in spec["train"]["steps"]:
        cfg, b, batches = tp_serve_train_build(spec, kind)
        params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(0))
        state = adamw_init(params, b.static["opt"])
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        rec = {"losses": [], "step_ms": []}
        for tokens, labels in batches:
            if card:
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            params, state, loss = b.fn(params, state, tokens.to(device),
                                       labels.to(device))
            rec["losses"].append(float(loss))
            rec["step_ms"].append(1e3 * (time.perf_counter() - t))
            check(np.isfinite(rec["losses"][-1]),
                  f"tp_serve train control {kind}: loss {loss}")
        rec.update(ms_per_step=float(np.mean(rec["step_ms"][1:])),
                   max_memory_allocated=torch.cuda.max_memory_allocated(
                       device) if card else None)
        save_lm_state(params, state, rec["losses"],
                      os.path.join(out_dir, f"train_{kind}_control.pt"),
                      torch.bfloat16 if kind == "float32" else None)
        recs[kind] = rec
        del params, state
        if card:
            free_card(device)
    return recs


def tp_serve_train_rank(device, mesh, spec: dict, run_dir: str,
                        collectives, sync) -> dict:
    """tp_serve's train case on this rank, each moment kind in turn: its
    pieces of the seeded weights drawn leaf by leaf and its ZeRO-1 share
    of fresh AdamW state (:func:`local_state`), the steps through the mesh
    step on its row of each batch, each timed with its collectives, the
    moment tensors the update formed recorded (:func:`recorded_moments`);
    then its pieces held to the control's (:func:`lm_pieces_hold`), and
    its moment bytes and largest moment tensor beside its share
    (:func:`share_sizes`)."""
    import torch

    from repro_torch.launch.steps import local_args, local_init
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import tree_leaves

    card = device.type == "cuda"
    out = {}
    for kind in spec["train"]["steps"]:
        cfg, b, batches = tp_serve_train_build(spec, kind, mesh)
        t = time.perf_counter()
        params = local_init(tfm.lm_param_specs(cfg), b.in_shardings[0],
                            torch.Generator(device).manual_seed(0))
        state = local_state(b, device)
        sync()
        share_bytes, limits = share_sizes(b)
        r = {"init_s": time.perf_counter() - t, "share_bytes": share_bytes,
             "moment_bytes": sum(x.numel() * x.element_size()
                                 for _, x in tree_leaves(state["mu"])),
             "losses": [], "step_ms": [], "collective_ms": [],
             "collective_bytes": []}
        if card:
            free_card(device)
            torch.cuda.reset_peak_memory_stats(device)
        largest = {}
        for tokens, labels in batches:
            tokens, labels = local_args(b, None, None, tokens.to(device),
                                        labels.to(device))[2:]
            collectives()
            sync()
            t = time.perf_counter()
            with recorded_moments(state) as seen:
                params, state, loss = b.fn(params, state, tokens, labels)
            sync()
            r["step_ms"].append(1e3 * (time.perf_counter() - t))
            c = collectives()
            r["collective_ms"].append(1e3 * c["s"])
            r["collective_bytes"].append(c["bytes"])
            r["losses"].append(float(loss))
            for leaf, n in seen.items():
                largest[leaf] = max(largest.get(leaf, 0), n)
        steady = r["step_ms"][1:] or r["step_ms"]
        worst = max(largest, key=lambda n: largest[n] / limits[n])
        r.update(ms_per_step=float(np.mean(steady)),
                 collective_share=float(np.sum(r["collective_ms"][1:]) /
                                        np.sum(steady)),
                 max_memory_allocated=torch.cuda.max_memory_allocated(device)
                 if card else None,
                 largest_moment={"leaf": worst, "elements": largest[worst],
                                 "share_limit": limits[worst],
                                 "bytes_float32": 4 * largest[worst]},
                 leaves_updated=sorted(largest) == sorted(limits),
                 over_share={n: [k, limits[n]] for n, k in largest.items()
                             if k > limits[n]})
        t = time.perf_counter()
        ctrl = torch.load(os.path.join(run_dir, f"train_{kind}_control.pt"),
                          mmap=True)
        r.update(lm_pieces_hold(b, params, state, ctrl, len(batches)))
        r.update(control_losses=ctrl["losses"],
                 compare_s=time.perf_counter() - t)
        del ctrl, params, state
        if card:
            free_card(device)
        out[kind] = r
    return out


def check_tp_serve_train(ranks: list, one: dict) -> None:
    """tp_serve's train case on every rank against the control: each
    step's loss within :data:`TP_TRAIN_LOSS_REL`, the parameters and
    moments within tp_train's limits, the moment bytes the placement's
    share exactly, no moment tensor past the share and every leaf
    updated."""
    for rank, r in enumerate(ranks):
        for kind, got in r["train"].items():
            what = f"tp_serve rank {rank} train ({kind} moments)"
            for i, (loss, want) in enumerate(zip(got["losses"],
                                                 one[kind]["losses"])):
                check(abs(loss - want) <= TP_TRAIN_LOSS_REL * abs(want),
                      f"{what}: step {i + 1} loss {loss} against the "
                      f"control's {want}")
            check(got["param_worst_share"] <= 1.0, f"{what}: a parameter "
                  f"off the control's by {got['param_worst_share']} x its "
                  "limit")
            for name, share in got["moment_worst_share"].items():
                check(share <= 1.0, f"{what}: moment {name} off the "
                      f"control's by {share} x its limit")
            check(got["moment_bytes"] == got["share_bytes"],
                  f"{what}: holds {got['moment_bytes']} bytes of moments, "
                  f"its share is {got['share_bytes']}")
            check(not got["over_share"] and got["leaves_updated"],
                  f"{what}: moment tensors past the share "
                  f"{got['over_share']}")


def tp_serve_spec() -> dict:
    """The tp_serve phase at full width; its MoE models' part in lm_tp's
    form (:data:`TP_SERVE_MOE`), its train case
    (:data:`TP_SERVE_TRAIN_LAYERS`)."""
    return {"arch": "qwen3-0.6b", "reduced": False,
            "layers": TP_SERVE_LAYERS, "mesh": list(TP_SERVE_MESH),
            "T": LONG_T, "len0": TP_SERVE_LEN0, "steps": TP_SERVE_STEPS,
            "p99": 512, "bulk": TP_SERVE_BULK,
            "train": {"arch": "qwen3-0.6b", "layers": TP_SERVE_TRAIN_LAYERS,
                      "lm": list(TP_SERVE_TRAIN_LM),
                      "steps": dict(TP_SERVE_TRAIN_STEPS), "lr": TRAIN_LR,
                      "eps": TP_SERVE_TRAIN_EPS},
            "moe": {"reduced": False, "mesh": list(TP_SERVE_MESH),
                    "slots": LM_SLOTS, "T": TP_T, "len0": TP_LEN0,
                    "long": [LONG_T, TP_LONG_LEN0],
                    "models": {arch: {"depth": list(depth),
                                      "prefill": list(prefill), "steps": n,
                                      "long_steps": 0}
                               for arch, (depth, prefill, n)
                               in TP_SERVE_MOE.items()}}}


def phase_tp_serve(device, spec: dict | None = None) -> dict:
    """Serving across ranks, part 2: the one-device control first
    (long_500k's decode steps on the whole seeded cache, MIND's three
    cells, then each model of :data:`TP_SERVE_MOE` by :func:`tp_control`),
    its outputs saved; then :data:`TP_SERVE_MESH`'s four ranks
    (:func:`tp_serve_rank`, gloo, sharing the card) in one start, each
    holding its joined long_500k logits to the control's within
    :data:`LM_LOGITS_ATOL`, its MIND outputs within :data:`MIND_TOL`
    (retrieval by :func:`_retrieval_agrees`), launching both flash-decode
    kernels once a layer a step and the bag in every MIND cell; the MoE
    models held as lm_tp holds them (:func:`check_tp`, at least
    :data:`MOE_HELD_SHARE` of the positions routed as the control's, each
    rank's rows of the batch; no weight gathered, every MoE call on the
    experts' embed pieces moving fewer bytes than their join; Arctic's
    decode launching kernel #5 once a layer a step), their dropped
    assignments counted (:func:`moe_drops`); the train case, its control
    after the MoE models', by :func:`check_tp_serve_train`.  Returns the
    kernels' launches summed over the ranks."""
    import torch

    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import recsys as rec

    spec = spec or tp_serve_spec()
    card = device.type == "cuda"
    P = spec["mesh"][0] * spec["mesh"][1]

    def sync():
        if card:
            torch.cuda.synchronize(device)

    if card:
        free_card(device)
    out = {"phase": "tp_serve", **spec, "logits_atol": LM_LOGITS_ATOL,
           "mind_tolerance": list(MIND_TOL),
           "held_share": MOE_HELD_SHARE,
           "reduced": {"long_500k_layers": [28, spec["layers"]],
                       "serve_bulk_users": [262_144, spec["bulk"]],
                       "decode_steps": spec["steps"]}}
    if spec.get("moe"):
        out["reduced"]["moe"] = {
            arch: tp_reduced(*tp_model(arch, spec["moe"]), spec["moe"], m)
            for arch, m in spec["moe"]["models"].items()}
    if spec.get("train"):
        out["reduced"]["train"] = {
            "train_4k (B, S)": [[256, 4096], spec["train"]["lm"]],
            "train_4k layers": [28, spec["train"]["layers"]]}
    t = time.perf_counter()
    ref, one = {}, {}
    with torch.inference_mode():
        cfg, params, decode, build = tp_serve_lm(spec, device)
        dec = build()
        warm = tp_cache(cfg, 1, 128 * P, P, range(P), device)
        warm["len"] = torch.tensor(5, dtype=torch.int32, device=device)
        dec.fn(params, decode[0], warm)
        del warm
        caches = tp_cache(cfg, 1, spec["T"], P, range(P), device)
        caches["len"] = torch.tensor(spec["len0"], dtype=torch.int32,
                                     device=device)
        ref["long_500k"], step_ms = [], []
        for tok in decode:
            sync()
            t0 = time.perf_counter()
            logits, caches = dec.fn(params, tok, caches)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            ref["long_500k"].append(logits.cpu())
        one["long_500k"] = {"step_ms": step_ms,
                            "ms_per_step": float(np.mean(step_ms)),
                            "cache_bytes": 2 * caches["k"].numel()
                            * caches["k"].element_size()}
        del params, caches, logits
        if card:
            free_card(device)
        mcfg, mparams, batches = tp_serve_mind(spec, device)
        on = {c: {k: v.to(device) for k, v in b.items()}
              for c, b in batches.items()}
        rec.mind_serve(mparams, mcfg, on["serve_p99"])  # warm
        rec.mind_retrieval(mparams, mcfg, on["retrieval_cand"])
        for cell in ("serve_p99", "serve_bulk"):
            sync()
            t0 = time.perf_counter()
            ref[cell] = rec.mind_serve(mparams, mcfg, on[cell])
            sync()
            one[cell] = {"wall_ms": 1e3 * (time.perf_counter() - t0)}
            ref[cell] = ref[cell].cpu()
        sync()
        t0 = time.perf_counter()
        vals, idx = rec.mind_retrieval(mparams, mcfg, on["retrieval_cand"],
                                       top_k=_TOP_K_HELD)
        sync()
        one["retrieval_cand"] = {"wall_ms": 1e3 * (time.perf_counter() - t0)}
        ref["retrieval_cand"] = (vals.cpu(), idx.cpu())
        del mparams, on, vals, idx
    if card:
        free_card(device)
    with tempfile.TemporaryDirectory() as tmp:
        if spec.get("moe"):
            one["moe"] = tp_control(device, spec["moe"], tmp)
        if spec.get("train"):
            one["train"] = tp_serve_train_control(device, spec, tmp)
        out["one_device"] = {**one, "wall_s": time.perf_counter() - t}
        torch.save(ref, os.path.join(tmp, "ref.pt"))
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        t = time.perf_counter()
        run_ranks("chip_smoke:tp_serve_rank", P, backend="gloo",
                  args=[tmp, device.type], paths=[ROOT],
                  timeout=TP_TIMEOUT_S, store_dir=tmp)
        out["ranks_wall_s"] = time.perf_counter() - t
        ranks, total = [], {}
        for rank in range(P):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                r = json.load(f)
            what = f"tp_serve rank {rank}"
            check(r["backend"] == "gloo", f"{what}: backend")
            long = r["long_500k"]
            worst = max(long["max_abs_logit_err"])
            check(worst <= LM_LOGITS_ATOL, f"{what}: long_500k logits "
                  f"differ from the one-device control's by {worst} > "
                  f"{LM_LOGITS_ATOL}")
            check(long["len_after"] == spec["len0"] + spec["steps"],
                  f"{what}: len")
            for name in ("flash_decode", "flash_decode_combine"):
                n = long["launches"].get(name, 0)
                check(n == spec["steps"] * long["layers"],
                      f"{what}: {name} launched {n} times, not "
                      f"{spec['steps']} steps x {long['layers']} layers")
                total[name] = total.get(name, 0) + n
            for cell, c in r["mind"].items():
                n = c["launches"].get("embedding_bag", 0)
                check(n == 1, f"{what}: {cell} launched the bag {n} times")
                total["embedding_bag"] = total.get("embedding_bag", 0) + n
            ranks.append(r)
        if spec.get("moe"):
            # Arctic's decode runs kernel #5 on each rank's cache piece
            # (MLA's latent decode none)
            _, moe = check_tp(spec["moe"], tmp, ranks, "tp_serve",
                              MOE_HELD_SHARE)
            for name, n in moe.items():
                total[name] = total.get(name, 0) + n
            out["moe_drops"] = moe_drops(spec["moe"], tmp, ranks)
        if spec.get("train"):
            check_tp_serve_train(ranks, one["train"])
    out.update(ranks=ranks, launches=total)
    emit(out)
    return total

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


def tp_train_inputs(spec: dict) -> tuple:
    """``(LM cfg, MIND cfg, LM batches, MIND batches)`` of the tp_train
    phase from its ``spec``: host tensors, one batch a step
    (``TokenSource`` / ``RecsysSource`` seed 0)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import RecsysSource, TokenSource

    lcfg, mcfg = get_config(spec["arch"]), get_config("mind")
    if spec["reduced"]:
        lcfg, mcfg = lcfg.reduced(), mcfg.reduced()
    if spec["layers"]:
        lcfg = replace(lcfg, n_layers=spec["layers"])
    B, S = spec["lm"]
    tok, rec = TokenSource(B, S, lcfg.vocab, seed=0), RecsysSource(
        mcfg, spec["users"], seed=0)
    lm = [tuple(torch.as_tensor(tok(i)[k]) for k in ("tokens", "labels"))
          for i in range(spec["steps"])]
    mind = [{k: torch.as_tensor(v) for k, v in rec(i).items()}
            for i in range(spec["steps"])]
    return lcfg, mcfg, lm, mind


def tp_train_moe(spec: dict) -> tuple:
    """``(base, cut cfg, batches)`` of the tp_train phase's MoE model
    (``spec["moe"]``): its config cut to ``depth`` (n_layers,
    first_k_dense) and ``experts`` routed experts, every width kept; one
    ``lm`` = (B, S) batch a step (``TokenSource`` seed 0, host
    tensors)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource

    moe = spec["moe"]
    base = get_config(moe["arch"])
    if spec["reduced"]:
        base = base.reduced()
    n_layers, dense = moe["depth"]
    cfg = replace(base, n_layers=n_layers, moe=replace(
        base.moe, first_k_dense=dense, num_experts=moe["experts"]))
    B, S = moe["lm"]
    tok = TokenSource(B, S, cfg.vocab, seed=0)
    batches = [tuple(torch.as_tensor(tok(i)[k]) for k in ("tokens", "labels"))
               for i in range(moe["steps"])]
    return base, cfg, batches


def tp_train_builds(spec: dict, lcfg, mcfg, mesh=None, moe_cfg=None) -> tuple:
    """The LM, MIND and (given ``moe_cfg``) MoE train steps of the
    tp_train phase on ``mesh`` (None: one device): the LM's on the cut
    ``(B, S)`` avals (one microbatch), AdamW at ``spec["lr"]``; the MoE
    model's on its cut avals with float32 moments (:data:`TP_TRAIN_MOE`)
    and ``build_step``'s default lr (at TRAIN_LR the first step moves each
    bf16 weight of scale 0.02 by 15%)."""
    import torch

    from repro_torch.launch import steps

    def lm_build(cfg, shape, opt):
        avals = {k: (tuple(shape), torch.int32) for k in ("tokens", "labels")}
        return steps._build_lm(cfg, "train_4k", "train", avals, mesh, opt,
                               False)

    lm = lm_build(lcfg, spec["lm"], steps.default_opt(lcfg, lr=spec["lr"]))
    mind = steps.build_step("mind", "train_batch", mesh,
                            reduced=spec["reduced"],
                            opt=steps.default_opt(mcfg, lr=spec["lr"]))
    moe = None if moe_cfg is None else lm_build(
        moe_cfg, spec["moe"]["lm"],
        steps.default_opt(moe_cfg, quantize_moments=False))
    return lm, mind, moe


def _on_host(tree, dtype=None):
    """A host copy of a tree of tensors (in ``dtype``, if given: a leaf
    converted where it lies, a card's leaf on the card, before it
    moves)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on_host(x, dtype) for x in tree)
    if hasattr(tree, "keys"):
        return {k: _on_host(tree[k], dtype) for k in tree.keys()}
    x = tree.detach()
    return (x if dtype is None else x.to(dtype)).to("cpu")


def moment_distance(got, want) -> tuple:
    """``got``'s distance from ``want`` (float32, on one device) as two
    shares of ``want``: the largest element's difference over its largest
    element, and the difference's norm over its norm."""
    import torch

    d = got - want
    norm = torch.linalg.vector_norm
    return (float(d.abs().max()) / max(float(want.abs().max()), 1e-30),
            float(norm(d)) / max(float(norm(want)), 1e-30))


def lm_pieces_hold(b, params, state, control: dict, steps: int,
                   bf16_steps: int = 2, move: float = 1.0,
                   moment_rel: dict = TP_TRAIN_MOMENT_REL,
                   moment_norm: bool = False,
                   leaves: dict | None = None) -> dict:
    """This rank's LM parameter and moment pieces against the one-device
    control's (``control``: its whole params and AdamW state, memmapped),
    cut by ``b``'s placements (int8 moments decoded block by block, the
    rank's blocks against the same blocks of the control's): each
    parameter within ``2 x
    move x lr`` a step (``move``: AdamW's largest step in units of lr)
    plus ``bf16_steps`` bf16 steps of its size (``param_worst_share``: the
    largest error over its limit), how many elements differ at all; each
    moment off the control's by a share of its leaf's largest (of its
    norm with ``moment_norm``), over ``moment_rel``; both shares of every
    leaf in ``leaves``, if given, and each's largest over the leaves in
    ``moment_shares``.  A ``control`` without ``params`` (a witness
    run's) holds the moments alone."""
    from repro_torch.launch.steps import _piece, _zip_map
    from repro_torch.models.params import tree_leaves

    want_p = control.get("params")  # None: its moments alone were kept
    want_s = control["state"] if b.in_shardings is None else _zip_map(
        _piece, control["state"], b.in_shardings[1])
    if want_p is not None and b.in_shardings is not None:
        want_p = _zip_map(_piece, want_p, b.in_shardings[0])
    lr = b.static["opt"].lr
    worst, unequal, elements, where = 0.0, 0, 0, {}
    for (name, got), (_, w) in zip(tree_leaves(params),
                                   tree_leaves(want_p or {})):
        g, w = got.detach().float(), w.to(got.device).float()
        err = (g - w).abs()
        lim = 2 * move * lr * steps + bf16_steps * BF16_STEP * w.abs()
        share = float((err / lim).max())
        if share > worst:
            worst, where["param"] = share, name
        unequal += int((err > 0).sum())
        elements += err.numel()
        del g, w, err, lim
    moments, shares = {}, {}
    got_mu, want_mu = (dict(tree_leaves(t["mu"])) for t in (state, want_s))
    for name, got in got_mu.items():
        leaf, key = name.rsplit(".", 1)
        if key.endswith("_s"):
            continue
        w = want_mu[name].to(got.device).float()
        if key.endswith("_q"):  # int8 blocks, each by its scale
            key, scale = key[0], f"{leaf}.{key[0]}_s"
            got = got.float() * got_mu[scale][:, None]
            w = w * want_mu[scale].to(got.device).float()[:, None]
        both = moment_distance(got.float(), w)
        share = both[moment_norm] / moment_rel[key]
        if leaves is not None:
            leaves[name] = both
        for kind, x in zip(("largest", "norm"), both):
            shares[f"{key}_of_{kind}"] = max(
                shares.get(f"{key}_of_{kind}", 0.0), x)
        if share > moments.get(key, 0.0):
            moments[key], where[key] = share, leaf
    return {"param_worst_share": worst, "params_unequal": unequal,
            "param_elements": elements, "moment_worst_share": moments,
            "moment_shares": shares, "worst_leaves": where}


def save_lm_state(params, state, losses, path, mu_dtype=None,
                  background=None, **extra):
    """An LM's state copied to the host (its moments in ``mu_dtype``, if
    given), then written to ``path`` (under another name first); with
    ``background`` (a dict) the writing runs in a thread, its seconds into
    ``background["write_s"]``.  ``params`` None: the moments alone."""
    import torch

    tree = {"state": {"step": state["step"].cpu(),
                      "mu": _on_host(state["mu"], mu_dtype)},
            "losses": losses, **extra}
    if params is not None:
        tree["params"] = _on_host(params)

    def write():
        t = time.perf_counter()
        torch.save(tree, path + ".part")
        os.replace(path + ".part", path)
        if background is not None:
            background["write_s"] = time.perf_counter() - t

    if background is None:
        write()
        return None
    thread = threading.Thread(target=write)
    thread.start()
    return thread


def whole_leaf_digests(b, params) -> dict:
    """The SHA-1 of the bytes of every leaf that ``b``'s placements leave
    whole on every rank (MoE's router, MLA's ``wq_a``, ``wkv_a`` and
    norms, MTP's ``proj`` and norms, every layer norm)."""
    import hashlib

    import torch

    from repro_torch.models.params import tree_leaves

    sh = dict(tree_leaves(b.in_shardings[0]))
    return {n: hashlib.sha1(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for n, t in tree_leaves(params) if sh[n].frac == 1}


def tp_train_rank(run_dir: str, device_type: str) -> None:
    """One rank of the tp_train phase (started by ``run_ranks``): the mesh
    ``spec["mesh"]`` over the group on ``cuda:(rank % visible cards)`` (or
    the CPU for a rehearsal).  The LM: this rank's pieces of the seeded
    weights and fresh AdamW state, the train steps through the mesh step,
    each timed with its collectives; then its parameter and moment pieces
    held to the one-device control's (``lm_control.pt``, memmapped, cut
    the same way: :func:`lm_pieces_hold`).  MIND: the same, the bag's
    launches counted from 0 around each step; after step 1 the joined
    (params, state) saved whole by rank 0 and restored onto the
    placements; then kernel #4 on this rank's profile rows at the last
    batch against the slot-order sum.  The MoE model (``spec["moe"]``):
    as the LM, its step-0 routes recorded and the digests of its whole
    leaves written (``moe_control.pt``).  Writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels.ref import embedding_bag_slot_order
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import gather_outputs, local_args, \
        local_init
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.train import checkpoint

    t_rank = time.perf_counter()
    rank = dist.get_rank()
    card = device_type == "cuda"
    device = torch.device("cuda", rank % torch.cuda.device_count()) \
        if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    with open(os.path.join(run_dir, "spec.json")) as f:
        spec = json.load(f)
    shape, axes = tuple(spec["mesh"]), ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    rec = {"rank": rank, "coords": mesh.coords(),
           "backend": dist.get_backend(), "device": str(device)}

    def sync():
        if card:
            torch.cuda.synchronize(device)

    def steps_of(b, params, state, batches, after=None) -> tuple:
        """The steps, each timed (ms, collectives' ms and calls)."""
        out = {"losses": [], "step_ms": [], "collective_ms": [],
               "collective_calls": [], "launches": []}
        for i, batch in enumerate(batches):
            batch = local_args(b, None, None, *batch)[2:]
            collectives()
            ebk.reset_launch_counts()
            sync()
            t = time.perf_counter()
            params, state, loss = b.fn(params, state, *batch)
            sync()
            out["step_ms"].append(1e3 * (time.perf_counter() - t))
            out["launches"].append(dict(ebk.LAUNCHES))
            c = collectives()
            out["collective_ms"].append(1e3 * c["s"])
            out["collective_calls"].append(c["calls"])
            out["losses"].append(float(loss))
            if after is not None:
                params, state = after(i, params, state)
        steady = out["step_ms"][1:] or out["step_ms"]
        coll = out["collective_ms"][1:] or out["collective_ms"]
        out.update(ms_per_step=float(np.mean(steady)),
                   collective_share=float(np.sum(coll) / np.sum(steady)))
        return params, state, out

    def lm_run(b, cfg, batches, control: str, routes: bool = False) -> dict:
        """An LM through the mesh step from this rank's pieces of the
        seeded weights (drawn leaf by leaf) and fresh float32 moments of
        them, held to ``control``'s state."""
        t = time.perf_counter()
        params = local_init(tfm.lm_param_specs(cfg), b.in_shardings[0],
                            torch.Generator(device).manual_seed(0))
        state = adamw_init(params, b.static["opt"])
        sync()
        init_s = time.perf_counter() - t
        if card:
            free_card(device)
            torch.cuda.reset_peak_memory_stats(device)
        first = []

        def after(i, params, state):
            if i == 0 and routes:
                first.extend(seen[:n_moe])
            seen.clear()
            return params, state

        n_moe = sum(d for _, d, moe in tfm.layer_groups(cfg) if moe)
        with recorded_routing() as seen:
            params, state, out = steps_of(
                b, params, state, [tuple(x.to(device) for x in bt)
                                   for bt in batches], after)
        out["init_s"] = init_s
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device) if card else None
        if routes:
            torch.save([r.cpu() for r in first],
                       os.path.join(run_dir, f"moe_routes_{rank}.pt"))
            out["whole_leaf_sha1"] = whole_leaf_digests(b, params)
        t = time.perf_counter()
        path = os.path.join(run_dir, control)
        while not os.path.exists(path):  # written beside the ranks' start
            time.sleep(0.5)
        ctrl = torch.load(path, mmap=True)
        hold = {} if not routes else {"bf16_steps": len(batches),
                                      "move": TP_TRAIN_MOE_MOVE,
                                      "moment_rel": TP_TRAIN_MOE_MOMENT_REL,
                                      "moment_norm": True}
        witness = routes and spec["moe"].get("witness")
        leaves = {} if witness else None
        out.update(lm_pieces_hold(b, params, state, ctrl, len(batches),
                                  leaves=leaves, **hold))
        out.update(control_losses=ctrl["losses"],
                   compare_s=time.perf_counter() - t)
        del ctrl
        if witness:  # the float32 run's state beside the control's
            wit = torch.load(os.path.join(run_dir, "moe_witness.pt"),
                             mmap=True)
            out["leaves"], out["witness_leaves"] = leaves, {}
            out["witness_hold"] = lm_pieces_hold(
                b, params, state, wit, len(batches),
                leaves=out["witness_leaves"], **hold)
            del wit
        del params, state
        if card:
            free_card(device)
        return out

    collectives = timed_collectives(sync)
    lcfg, mcfg, lm_batches, mind_batches = tp_train_inputs(spec)
    moe_cfg = tp_train_moe(spec)[1:] if spec.get("moe") else (None, None)
    lm, mind, moe = tp_train_builds(spec, lcfg, mcfg, mesh, moe_cfg[0])
    # ---- the LM: Megatron TP, the vocab-parallel loss
    rec["lm"] = lm_run(lm, lcfg, lm_batches, "lm_control.pt")
    # ---- MIND: rows over model, saved and restored after step 1
    t = time.perf_counter()
    whole = recsys.mind_init(mcfg, torch.Generator(device).manual_seed(0))
    params, state = local_args(mind, whole, adamw_init(whole, mind.static[
        "opt"]))[:2]
    del whole
    sync()
    rec["mind_init_s"] = time.perf_counter() - t
    ckpt = os.path.join(run_dir, "mind_ckpt")

    def save_and_restore(i, params, state):
        if i:
            return params, state
        t = time.perf_counter()
        whole = gather_outputs(mind, (params, state))
        if rank == 0:
            checkpoint.save(ckpt, 1, whole)
        del whole
        dist.barrier()
        tree, step = checkpoint.restore(ckpt, (params, state),
                                        device=device,
                                        shardings=mind.in_shardings[:2])
        check(step == 1, f"tp_train rank {rank}: restored step {step}")
        sync()
        rec["mind_save_restore_s"] = time.perf_counter() - t
        return tree

    if card:
        torch.cuda.reset_peak_memory_stats(device)
    batches = [({k: v.to(device) for k, v in b.items()},)
               for b in mind_batches]
    params, state, rec["mind"] = steps_of(mind, params, state, batches,
                                          save_and_restore)
    rec["mind"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(
        device) if card else None
    # kernel #4 on this rank's rows, the last batch's bags
    table = params["profile_embed"].detach()
    rows, index = table.shape[0], mesh.axis_index("model")
    flat = batches[-1][0]["profile_ids"].reshape(-1, mcfg.profile_bag).long()
    local = flat - index * rows
    local = torch.where((local >= 0) & (local < rows), local,
                        -1).to(torch.int32).contiguous()
    got = ebk.launch_bag(table, local, None, "sum") if card else \
        ebk.bag_plain(table, local, None, "sum")
    rec["mind"]["bag_bit_for_bit"] = bool(torch.equal(
        got, embedding_bag_slot_order(table, local, "sum")))
    rec["mind"]["bag_masked_share"] = float((local < 0).float().mean())
    del params, state, batches, table, flat, local, got
    if card:
        free_card(device)
    # ---- the MoE model: experts, MLA's heads and MTP over model
    if moe is not None:
        rec["moe"] = lm_run(moe, moe_cfg[0], moe_cfg[1], "moe_control.pt",
                            routes=True)
    rec["rank_s"] = time.perf_counter() - t_rank
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def tp_train_spec(witness: bool = False) -> dict:
    """The tp_train phase at full width, DeepSeek-V3 cut as
    :data:`TP_TRAIN_MOE`; with ``witness`` its float32 run beside the
    control (:func:`tp_train_witness`), as ``--tp-train-witness`` runs
    it."""
    return {"arch": "qwen3-0.6b", "reduced": False,
            "layers": TP_TRAIN_LAYERS, "mesh": list(TP_TRAIN_MESH),
            "lm": list(TP_TRAIN_LM), "users": TP_TRAIN_USERS,
            "steps": TP_TRAIN_STEPS, "lr": TRAIN_LR,
            "moe": {"arch": "deepseek-v3-671b", "depth": list(TP_TRAIN_MOE[0]),
                    "experts": TP_TRAIN_MOE[1], "lm": list(TP_TRAIN_MOE[2]),
                    "steps": TP_TRAIN_STEPS, "witness": witness}}


def phase_tp_train(device, spec: dict | None = None) -> tuple:
    """Training over a model axis of 2: the one-device control first
    (Qwen3-0.6B's train_4k cut as :data:`TP_TRAIN_LAYERS` and
    :data:`TP_TRAIN_LM`, MIND's train_batch at :data:`TP_TRAIN_USERS`
    users, then DeepSeek-V3 cut as :data:`TP_TRAIN_MOE`, with step 0's
    loss held to the no-grad forward's, :data:`TP_TRAIN_STEPS` steps
    each), the LMs' states saved and freed; then :data:`TP_TRAIN_MESH`'s
    ranks (:func:`tp_train_rank`, gloo, sharing the card), each holding
    its losses to the control's (:data:`TP_TRAIN_LOSS_REL`,
    :data:`TP_TRAIN_MIND_TOL`), its LM pieces to the control's state,
    MIND's step 2 after the save and restore to the uninterrupted
    control's, and launching kernel #4 once a MIND step, bit for bit the
    slot-order sum on its rows; DeepSeek-V3's whole leaves equal on both
    ranks and its step-0 routes the control's at :data:`MOE_HELD_SHARE`
    of the positions or more.  Returns the kernels' launches summed over
    the ranks' MIND steps, and kernel #4 timed at a rank's row piece of
    the train bags."""
    import torch

    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init

    spec = spec or tp_train_spec()
    card = device.type == "cuda"
    world = spec["mesh"][0] * spec["mesh"][1]

    def sync():
        if card:
            torch.cuda.synchronize(device)

    def timed(b, params, state, batches, first=None) -> tuple:
        losses, ms = [], []
        for i, batch in enumerate(batches):
            sync()
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                seen = stack.enter_context(recorded_routing()) \
                    if i == 0 and first is not None else None
                params, state, loss = b.fn(params, state, *batch)
            if seen is not None:
                first.extend(seen)
            sync()
            ms.append(1e3 * (time.perf_counter() - t))
            losses.append(float(loss))
        return params, state, {"losses": losses, "step_ms": ms,
                               "ms_per_step": float(np.mean(ms[1:] or ms))}

    if card:
        free_card(device)
    lcfg, mcfg, lm_batches, mind_batches = tp_train_inputs(spec)
    out = {"phase": "tp_train", **spec,
           "tolerances": {"lm_loss_rel": TP_TRAIN_LOSS_REL,
                          "lm_params": "2 x lr a step + 2 bf16 steps",
                          "moe_params": "2 x TP_TRAIN_MOE_MOVE x lr a step "
                                        "+ a bf16 step a step",
                          "lm_moments_of_largest": TP_TRAIN_MOMENT_REL,
                          "moe_moments_of_norm": TP_TRAIN_MOE_MOMENT_REL,
                          "mind_loss": TP_TRAIN_MIND_TOL,
                          "moe_positions_routed_alike": MOE_HELD_SHARE,
                          "moe_step0_loss_rel": TRAIN_MOE_LOSS_REL},
           "reduced": {"train_4k (B, S)": [[256, 4096], spec["lm"]],
                       "train_4k layers": [28, lcfg.n_layers],
                       "train_batch users": [65_536, spec["users"]]}}
    moe_base = moe_cfg = moe_batches = None
    if spec.get("moe"):
        moe_base, moe_cfg, moe_batches = tp_train_moe(spec)
        out["reduced"]["moe"] = {
            "train_4k (B, S)": [[256, 4096], spec["moe"]["lm"]],
            "n_layers": [moe_base.n_layers, moe_cfg.n_layers],
            "first_k_dense": [moe_base.moe.first_k_dense,
                              moe_cfg.moe.first_k_dense],
            "num_experts": [moe_base.moe.num_experts,
                            moe_cfg.moe.num_experts]}
    lm, mind, moe = tp_train_builds(spec, lcfg, mcfg, moe_cfg=moe_cfg)
    one = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        params = tfm.lm_init(lcfg, torch.Generator(device).manual_seed(0))
        state = adamw_init(params, lm.static["opt"])
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        params, state, one["lm"] = timed(
            lm, params, state, [tuple(x.to(device) for x in b)
                                for b in lm_batches])
        one["lm"]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(device) if card else None
        t0 = time.perf_counter()
        # the moments in bf16 (2.25 GB saved, not 3.75): a rounding of at
        # most 2^-9 of a value, against limits of 5% / 10% of the largest
        save_lm_state(params, state, one["lm"]["losses"],
                      os.path.join(tmp, "lm_control.pt"), torch.bfloat16)
        one["lm"]["save_s"] = time.perf_counter() - t0
        del params, state
        if card:
            free_card(device)
        params = recsys.mind_init(mcfg, torch.Generator(device).manual_seed(0))
        profile_embed = params["profile_embed"].detach().clone()
        state = adamw_init(params, mind.static["opt"])
        params, state, one["mind"] = timed(
            mind, params, state, [({k: v.to(device) for k, v in b.items()},)
                                  for b in mind_batches])
        del params, state
        if card:
            free_card(device)
        if moe is not None:
            # DeepSeek-V3 (the train phase's dense layer and MTP, one MoE
            # layer beside them), its moments saved in bf16 as the LM's
            t0 = time.perf_counter()
            params = tfm.lm_init(moe_cfg, torch.Generator(device).manual_seed(0))
            state = adamw_init(params, moe.static["opt"])
            sync()
            init_s = time.perf_counter() - t0
            args = [tuple(x.to(device) for x in b) for b in moe_batches]
            want = lm_xent_no_grad(params, moe_cfg, *args[0],
                                   moe.static["accum"])
            if card:
                torch.cuda.reset_peak_memory_stats(device)
            routes = []
            params, state, one["moe"] = timed(moe, params, state, args,
                                              routes)
            n_moe = sum(d for _, d, m in tfm.layer_groups(moe_cfg) if m)
            routes = [r.cpu() for r in routes[:n_moe]]
            rel = abs(one["moe"]["losses"][0] - want) / abs(want)
            check(rel <= TRAIN_MOE_LOSS_REL, f"tp_train deepseek control: step "
                  f"0 loss {one['moe']['losses'][0]} against the no-grad "
                  f"forward's {want}")
            one["moe"].update(
                init_s=init_s, no_grad_loss=want, loss_rel=rel,
                max_memory_allocated=torch.cuda.max_memory_allocated(device)
                if card else None)
            # written beside the ranks' start: a rank reads it after its
            # LM and MIND runs
            t0 = time.perf_counter()
            # a witness run keeps the moments alone: two whole states
            # beside each other would write ~55 GB to the disk
            saving = save_lm_state(
                None if spec["moe"].get("witness") else params, state,
                one["moe"]["losses"], os.path.join(tmp, "moe_control.pt"),
                torch.bfloat16, one["moe"], routes=routes)
            one["moe"]["host_copy_s"] = time.perf_counter() - t0
            del params, state, args
            if card:
                free_card(device)
            if spec["moe"].get("witness"):
                saving.join()
                one["moe_witness"] = tp_train_witness(
                    device, moe_cfg, moe_batches, moe.static["opt"], tmp)
        out["one_device"] = {**one, "wall_s": time.perf_counter() - t}
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        t = time.perf_counter()
        # two ranks' DeepSeek-V3 steps peak together (~33 GB each):
        # segments that grow, not a cache of fixed blocks beside them
        run_ranks("chip_smoke:tp_train_rank", world, backend="gloo",
                  args=[tmp, device.type], paths=[ROOT],
                  timeout=TP_TIMEOUT_S, store_dir=tmp,
                  env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        out["ranks_wall_s"] = time.perf_counter() - t
        if moe is not None:
            saving.join()
        ranks, total = [], {}
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                r = json.load(f)
            what = f"tp_train rank {rank}"
            check(r["backend"] == "gloo", f"{what}: backend")
            models = [("lm", "LM")] + ([("moe", "DeepSeek-V3")]
                                       if moe is not None else [])
            for key, label in models:
                for got, want in zip(r[key]["losses"], one[key]["losses"]):
                    check(abs(got - want) <= TP_TRAIN_LOSS_REL * abs(want),
                          f"{what}: {label} loss {got} against the "
                          f"control's {want}")
                check(r[key]["param_worst_share"] <= 1.0,
                      f"{what}: a {label} parameter off the control's by "
                      f"{r[key]['param_worst_share']} x its limit")
                for name, share in r[key]["moment_worst_share"].items():
                    check(share <= 1.0, f"{what}: {label} moment {name} off "
                          f"the control's by {share} x its limit")
            for i, (got, want) in enumerate(zip(r["mind"]["losses"],
                                                one["mind"]["losses"])):
                check(abs(got - want) <= TP_TRAIN_MIND_TOL * max(1.0, abs(
                    want)), f"{what}: MIND step {i + 1} loss {got} against "
                    f"the uninterrupted control's {want}")
            for i, n in enumerate(r["mind"]["launches"]):
                got = n.get("embedding_bag", 0)
                check(got == 1, f"{what}: MIND step {i + 1} launched the "
                      f"bag {got} times")
                total["embedding_bag"] = total.get("embedding_bag", 0) + got
            check(r["mind"]["bag_bit_for_bit"], f"{what}: kernel #4 on the "
                  "rank's rows != the slot-order sum")
            ranks.append(r)
        if moe is not None:
            out["moe"] = tp_train_moe_hold(tmp, ranks)
    t = time.perf_counter()
    flat = mind_batches[0]["profile_ids"].reshape(-1, mcfg.profile_bag)
    entry = local_bag_entry(device, profile_embed, flat.to(device),
                            backward=True) if card else None
    out.update(ranks=ranks, launches=total, bag=entry,
               bag_entry_s=time.perf_counter() - t)
    emit(out)
    return total, entry


def tp_train_witness(device, cfg, batches, opt, run_dir: str) -> dict:
    """The tp_train phase's MoE model once more on one device in float32,
    a second witness beside its bf16 control: the control's bf16 weights
    (seed 0) raised to float32, its batches through ``lm_loss`` of the
    config in float32 (TF32 off), then ``optim.adamw_update`` a leaf at a
    time with float32 moments kept in pinned host memory (the card holds
    the float32 weights, gradients and activations; the moments beside
    them would not fit).  Writes its state as the control's
    (``moe_witness.pt``: its bf16 moments) and returns its losses,
    step times, peak device memory and each moment leaf's distance from
    the control's (``moe_control.pt``), both shares of
    :func:`moment_distance` as the ranks' are measured, printed before the
    write."""
    from dataclasses import replace

    import torch

    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw_update
    from repro_torch.optim.optimizer import _leaf_state

    card = device.type == "cuda"
    f32 = torch.float32

    def sync():
        if card:
            torch.cuda.synchronize(device)

    t = time.perf_counter()
    params = tree_map(lambda p: p.to(f32), tfm.lm_init(
        cfg, torch.Generator(device).manual_seed(0)))
    mu = tree_map(lambda p: {k: torch.zeros(p.shape, dtype=f32,
                                            pin_memory=card)
                             for k in ("m", "v")}, params)
    step = torch.zeros((), dtype=torch.int32, device=device)
    sync()
    rec = {"init_s": time.perf_counter() - t, "losses": [], "step_ms": []}
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    wide = replace(cfg, dtype=f32)
    for tokens, labels in batches:
        sync()
        t = time.perf_counter()
        loss, grads = value_and_grad(tfm.lm_loss, params, wide,
                                     tokens.to(device), labels.to(device))
        for i, (name, p) in enumerate(tree_leaves(params)):
            host = _leaf_state(mu, name)
            leaf = {k: host[k].to(device, non_blocking=True)
                    for k in ("m", "v")}
            adamw_update({"w": p}, [grads[i]], {"step": step.clone(),
                                                "mu": {"w": leaf}}, opt)
            grads[i] = None
            for k in ("m", "v"):
                host[k].copy_(leaf[k], non_blocking=True)
            del leaf
        step += 1
        sync()
        rec["step_ms"].append(1e3 * (time.perf_counter() - t))
        rec["losses"].append(float(loss))
        del grads
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(
        device) if card else None
    t = time.perf_counter()
    ctrl = torch.load(os.path.join(run_dir, "moe_control.pt"), mmap=True)
    leaves = {name: moment_distance(got.to(device), _leaf_state(
        ctrl["state"]["mu"], name).to(device).float())
        for name, got in tree_leaves(mu)}
    rec["control_losses"] = ctrl["losses"]
    del ctrl
    rec["leaves"] = leaves
    rec["moment_shares"] = {
        f"{k}_of_{kind}": max(v[i] for n, v in leaves.items()
                              if n.endswith("." + k))
        for k in ("m", "v") for i, kind in enumerate(("largest", "norm"))}
    rec["compare_s"] = time.perf_counter() - t
    emit({"phase": "tp_train_witness", **rec})
    t = time.perf_counter()
    torch.save({"state": {"step": step.cpu(),
                          "mu": _on_host(mu, torch.bfloat16)},
                "losses": rec["losses"]},
               os.path.join(run_dir, "moe_witness.pt"))
    rec["save_s"] = time.perf_counter() - t
    del params, mu
    if card:
        free_card(device)
    return rec


def tp_train_moe_hold(run_dir: str, ranks: list) -> dict:
    """The MoE model's checks across the tp_train ranks: every whole
    leaf's digest equal on every rank, and each rank's step-0 routes the
    control's at :data:`MOE_HELD_SHARE` of the positions or more (a
    position held where its token took the control's experts in every
    MoE layer, as lm_tp holds them)."""
    import torch

    first = ranks[0]["moe"]["whole_leaf_sha1"]
    for r, rank in enumerate(ranks[1:], 1):
        diff = sorted(n for n, h in rank["moe"]["whole_leaf_sha1"].items()
                      if first.get(n) != h)
        check(not diff and set(first) == set(rank["moe"]["whole_leaf_sha1"]),
              f"tp_train DeepSeek-V3 rank {r}: whole leaves {diff} differ "
              "from rank 0's")
    want = torch.load(os.path.join(run_dir, "moe_control.pt"),
                      mmap=True)["routes"]
    out = {"whole_leaves": sorted(first), "held": []}
    for r in range(len(ranks)):
        got = torch.load(os.path.join(run_dir, f"moe_routes_{r}.pt"))
        check(len(got) == len(want) > 0, f"tp_train DeepSeek-V3 rank {r}: "
              f"{len(got)} routings recorded, the control {len(want)}")
        held = torch.stack([(g == w).all(-1) for g, w in zip(got, want)]
                           ).all(0)
        share = float(held.float().mean())
        check(share >= MOE_HELD_SHARE, f"tp_train DeepSeek-V3 rank {r}: "
              f"step 0 routed {share} of the positions as the control")
        out["held"].append({"positions": held.numel(),
                            "held": int(held.sum()), "share": share})
    return out


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


def local_bag_entry(device, profile_embed, ids=None,
                    backward: bool = False) -> dict:
    """Kernel #4 in the mode of MIND's rows over model, timed alone: a
    model rank's ``sum`` bags over its row piece (the first of
    ``TP_SERVE_BAGS[2]``) of MIND's profile table, at ``ids`` (bags x
    slots; None: :data:`TP_SERVE_BAGS` bags x slots of serve_p99's seeded
    ids) with those the rank does not hold masked; held to its plain
    version and, bit for bit, to the slot-order sum; its bound by the
    bytes it must move (the ids, the bags and each distinct row it reads,
    once).  With ``backward`` also the bag's backward (plain torch,
    ``bag_backward``: the gradient of the whole row piece), timed beside
    its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.kernels.ref import embedding_bag_slot_order

    M = TP_SERVE_BAGS[2]
    N, D = profile_embed.shape
    rows = N // M
    table = profile_embed[:rows]
    if ids is None:
        B, L = TP_SERVE_BAGS[:2]
        ids = torch.as_tensor(np.random.default_rng(7).integers(
            0, N, (B, L)).astype(np.int32), device=device)
    B, L = ids.shape
    idx = torch.where(ids < rows, ids, -1).to(torch.int32).contiguous()
    valid = int((idx >= 0).sum())
    got = ebk.embedding_bag(table, idx, mode="sum")
    want = ebk.bag_plain(table, idx, None, "sum")
    err = _close(got, want, (1e-5, 1e-5), "embedding_bag on a row piece")
    check(torch.equal(got, embedding_bag_slot_order(table, idx, "sum")),
          "embedding_bag on a row piece != the slot-order sum bit for bit")
    weights = (idx >= 0).float()

    def library():  # one PyTorch call: masked slots weighted 0
        return F.embedding_bag(idx.clamp(min=0), table, mode="sum",
                               per_sample_weights=weights)

    _close(library(), want, (1e-5, 1e-5), "F.embedding_bag on a row piece")
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    nbytes = 4 * B * L + 4 * B * D + 4 * distinct * D
    bms, by = bound(nbytes, valid * D, F32_OPS_PER_S)
    grad = {}
    if backward:
        g = torch.randn((B, D), device=device,
                        generator=torch.Generator(device).manual_seed(3))
        # the grad of the whole piece written, the ids and grad_out read
        back = 4 * B * L + 4 * B * D + 4 * rows * D
        grad = {"backward_ms": cuda_ms(lambda: ebk.bag_backward(
            g, table, idx, None, "sum", False), 5, device),
            "backward_bound_ms": bound(back, valid * D, F32_OPS_PER_S)[0],
            "backward_bytes": back}
    return {**grad, "max_abs_err": err, "ms": device_ms(
        lambda: ebk.embedding_bag(table, idx, mode="sum"), 200, device),
        "plain_ms": cuda_ms(lambda: ebk.bag_plain(table, idx, None, "sum"),
                            3, device),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(library, 200, device),
        "tolerance": [1e-5, 1e-5],
        "parity": "bit-identical to the slot-order sum",
        "plan": ebk.card_plan(table, idx),
        "shape": {"bags": B, "slots": L, "D": D, "rows": rows,
                  "of_rows": N, "pieces": M, "valid_slots": valid,
                  "masked_share": 1 - valid / (B * L),
                  "distinct_rows": distinct, "mode": "sum",
                  "dtype": "float32", "bytes": nbytes}}


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


def piece_entries(device, B: int, T: int, P: int, len0: int, phase: str,
                  heads: tuple = DECODE_HEADS) -> tuple:
    """Kernel #5 in a sequence-split phase's modes at its shape: bf16
    caches of ``heads`` = (H, Hkv, d) (Qwen3-0.6B's :data:`DECODE_HEADS`
    unless given) of ``B`` rows over ``T`` positions cut into ``P`` pieces
    (lm_tp: :data:`LM_SLOTS` x :data:`TP_T` in ``TP_MESH[1]``, Qwen3-0.6B's
    heads and Arctic's; tp_serve: 1 x :data:`LONG_T` in four).
    At cache_len 0, 1, one below, at and one above each piece boundary,
    ``len0`` and T: the split kernel on each piece at its offset held to
    :func:`split_plain` (m, l and acc of the splits the piece's plan
    gives), and the combine over the stacked pieces held to
    :func:`combine_plain` on the kernel's partials and to the whole cache's
    plain attention, each to :func:`bf16_hold`'s limit; where the last
    piece holds at least an eighth of the positions attended, that limit
    rejects the merge with the last piece's partial dropped (l = acc = 0)
    or weighted twice.  Timed at ``len0``, where ``phase``'s decode steps
    start.  Returns the split's and the combine's records."""
    import torch

    from repro_torch.kernels import flash_decode as fdk

    H, Hkv, d = heads
    G = H // Hkv
    Tp = T // P
    gen = torch.Generator(device).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16) for shape in ((B, H, d), (B, T, Hkv, d),
                                      (B, T, Hkv, d)))
    pieces = [(k[:, p * Tp:(p + 1) * Tp], v[:, p * Tp:(p + 1) * Tp])
              for p in range(P)]
    lens_held = sorted({0, 1, len0, T,
                        *(x for p in range(1, P)
                          for x in (p * Tp - 1, p * Tp, p * Tp + 1))})
    held = []
    for n in lens_held:
        lens = torch.tensor(n, dtype=torch.int32, device=device)
        parts, rec = [], {"cache_len": n, "split_err": [], "splits": []}
        covered = []
        for p, (kp, vp) in enumerate(pieces):
            ml, acc = fdk.launch_split(q, kp, vp, lens, p * Tp)
            ml_p, acc_p = fdk.split_plain(q, kp, vp, lens, p * Tp)
            ns = fdk.piece_plan(n, p * Tp, Tp, B, Hkv, G)[2]
            check(ns == 0 if 0 < n <= p * Tp else ns >= 1,
                  f"piece {p} at cache_len {n}: {ns} splits")
            errs = {}
            for what, got, want in (
                    ("m", ml[:, :, :ns, :, 0], ml_p[:, :, :ns, :, 0]),
                    ("l", ml[:, :, :ns, :, 1], ml_p[:, :, :ns, :, 1]),
                    ("acc", acc[:, :, :ns], acc_p[:, :, :ns])):
                if ns:
                    err, lim = bf16_hold(got, want)
                    check(err <= lim, f"split piece {p} {what} at cache_len "
                          f"{n}: error {err} > limit {lim}")
                    errs[what] = [err, lim]
            rec["split_err"].append(errs)
            rec["splits"].append(ns)
            covered.append(fdk.piece_plan(n, p * Tp, Tp, B, Hkv, G)[0]
                           if ns else 0)
            parts.append((ml, acc))
        ml, acc = (torch.stack(t) for t in zip(*parts))
        got = fdk.launch_combine(ml, acc, lens, Tp, q.dtype)
        want = fdk.combine_plain(ml, acc, lens, Tp, q.dtype)
        err, lim = bf16_hold(got, want)
        check(err <= lim, f"combine of {P} pieces at cache_len {n}: error "
              f"{err} > limit {lim}")
        whole = fdk.decode_attention_plain(q, k, v, lens)
        werr, wlim = bf16_hold(got, whole)
        check(werr <= wlim, f"{P} pieces against the whole cache at "
              f"cache_len {n}: error {werr} > limit {wlim}")
        rec.update(combine_err=err, combine_limit=lim, whole_err=werr)
        if 8 * covered[-1] >= sum(covered):
            planted = {}
            for name, scale in (("last_piece_dropped", 0.0),
                                ("last_piece_twice", 2.0)):
                ml_, acc_ = ml.clone(), acc.clone()
                ml_[-1, ..., 1] *= scale
                acc_[-1] *= scale
                planted[name] = bf16_hold(fdk.combine_plain(
                    ml_, acc_, lens, Tp, q.dtype), whole)[0]
                check(planted[name] > wlim, f"cache_len {n}: the limit "
                      f"{wlim} does not reject the planted fault {name}")
            rec["planted_err"] = planted
        held.append(rec)
    # timed at len0, where the phase's decode steps run
    n = len0
    lens = torch.tensor(n, dtype=torch.int32, device=device)
    parts = [fdk.launch_split(q, kp, vp, lens, p * Tp)
             for p, (kp, vp) in enumerate(pieces)]
    ml, acc = (torch.stack(t) for t in zip(*parts))
    rec = next(h for h in held if h["cache_len"] == n)
    counts = rec["splits"]
    covered = [fdk.piece_plan(n, p * Tp, Tp, B, Hkv, G)[0] if counts[p]
               else 0 for p in range(P)]
    piece_ms, piece_plain_ms = [], []
    for p, (kp, vp) in enumerate(pieces):
        piece_ms.append(device_ms(
            lambda: fdk.launch_split(q, kp, vp, lens, p * Tp), 50, device))
        piece_plain_ms.append(cuda_ms(
            lambda: fdk.split_plain(q, kp, vp, lens, p * Tp), 3, device))
    # each piece's k and v below cache_len and q read once, its partials
    # written once
    nbytes = 2 * 2 * B * sum(covered) * Hkv * d + P * 2 * B * H * d + \
        4 * B * Hkv * sum(counts) * G * (d + 2)
    bms, by = bound(nbytes, 4 * B * H * sum(covered) * d, BF16_OPS_PER_S)
    shape = {"B": B, "T": T, "pieces": P, "T_piece": Tp, "cache_len": n,
             "H": H, "Hkv": Hkv, "d": d, "dtype": "bfloat16",
             "covered": covered, "splits": counts}
    split = {
        "max_abs_err": max(e[0] for errs in rec["split_err"]
                           for e in errs.values()),
        "ms": sum(piece_ms), "piece_ms": piece_ms,
        "plain_ms": sum(piece_plain_ms), "piece_plain_ms": piece_plain_ms,
        "bound_ms": bms, "bound_by": by, "bytes": nbytes,
        "library_ms": None,
        "tolerance": "2**-7 * max|want| (m, l, acc each)",
        "held": held, "shape": shape,
        "note": f"each piece's split at its offset (each rank of {phase} "
                "runs one); ms, plain_ms, bound_ms summed over the pieces"}
    ns = fdk.max_splits(Tp, B, Hkv, G)
    cbytes = 4 * B * Hkv * sum(counts) * G * (d + 2) + 4 + 2 * B * H * d
    cbms, cby = bound(cbytes, 3 * B * Hkv * sum(counts) * G * d,
                      F32_OPS_PER_S)
    combine = {
        "max_abs_err": rec["combine_err"], "limit": rec["combine_limit"],
        "ms": device_ms(lambda: fdk.launch_combine(ml, acc, lens, Tp,
                                                   q.dtype), 50, device),
        "plain_ms": cuda_ms(lambda: fdk.combine_plain(ml, acc, lens, Tp,
                                                      q.dtype), 3, device),
        "bound_ms": cbms, "bound_by": cby, "library_ms": None,
        "bytes": cbytes, "shape": {**shape, "max_splits": ns},
        "note": f"the {P} pieces' partials stacked, every query head"}
    del q, k, v, pieces, parts, ml, acc
    return split, combine


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
    timed["lm_tp_pieces"], combine["lm_tp_pieces"] = piece_entries(
        device, LM_SLOTS, TP_T, TP_MESH[1], TP_LEN0, "lm_tp")
    timed["tp_moe_pieces"], combine["tp_moe_pieces"] = piece_entries(
        device, LM_SLOTS, TP_T, TP_MESH[1], TP_LEN0, "lm_tp arctic-480b",
        ARCTIC_HEADS)
    timed["tp_serve_pieces"], combine["tp_serve_pieces"] = piece_entries(
        device, 1, LONG_T, TP_SERVE_MESH[0] * TP_SERVE_MESH[1],
        TP_SERVE_LEN0, "tp_serve")
    timed["tp_serve_moe_pieces"], combine["tp_serve_moe_pieces"] = \
        piece_entries(device, LM_SLOTS // TP_SERVE_MESH[0], TP_T,
                      TP_SERVE_MESH[1], TP_LEN0, "tp_serve arctic-480b",
                      ARCTIC_HEADS)
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
    global FAILED_CHECKS
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
    if argv[:1] == ["--tp-train-witness"]:
        # the tp_train phase alone with DeepSeek-V3's float32 witness, its
        # checks reported beside the readings, not raised
        FAILED_CHECKS = []
        phase_build()
        phase_tp_train(device, tp_train_spec(witness=True))
        emit({"phase": "failed_checks", "checks": FAILED_CHECKS})
        return 1 if FAILED_CHECKS else 0
    phase_build()
    # the outofcore phase's two builds, each in a child process from here
    # on, beside the phases before that one
    builds = (ChildBuild("none", FULL), ChildBuild("degree", SMALL))
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
    outofcore = phase_outofcore(device, g, r, small, builds)
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
    # the process-group path's launches: counts set to 0 in every rank
    # before each of its runs and read after it, summed over the ranks
    dist_launches = phase_dist(device, g, r)
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
        # Megatron TP over two gloo ranks sharing the card: counts set to
        # 0 in every rank before each model's decode steps, summed over the
        # ranks (Qwen3-0.6B's, and Arctic's with its experts over model)
        lm_tp, tp_moe = phase_lm_tp(device)
        # long_500k's sequence over four gloo ranks and MIND's rows over
        # model, one start: counts set to 0 in every rank before each
        # run, summed over the ranks
        tp_serve = phase_tp_serve(device)
        lm_moe = phase_lm_moe(device)
        # the train path's launches: MIND's five steps, counts set to 0
        # before them
        train, bag_train = phase_train(device)
        # training over a model axis of 2 (two gloo ranks sharing the
        # card): counts set to 0 in every rank before each MIND step,
        # summed over the ranks
        tp_train, bag_tp_train = phase_tp_train(device)
        # the GNN zoo's runs: counts set to 0 before each run's steps, none
        # of the kernels on its path
        gnn = phase_gnn(device, drawn)
    entries += bag_entries(device, launches, profile_embed, profile_ids)
    bag = next(e for e in entries if e["name"] == "embedding_bag")
    bag["train_batch"] = bag_train
    bag["tp_serve_local"] = local_bag_entry(device, profile_embed)
    bag["tp_train_local"] = bag_tp_train
    entries += decode_entries(device, launches)
    for entry in entries:
        entry["maintain_launches"] = maintain.get(entry["name"], 0)
        entry["outofcore_launches"] = outofcore.get(entry["name"], 0)
        entry["stream_launches"] = stream.get(entry["name"], 0)
        entry["shard_launches"] = shard.get(entry["name"], 0)
        entry["dist_launches"] = dist_launches.get(entry["name"], 0)
        entry["lm_prefill_launches"] = lm_prefill.get(entry["name"], 0)
        entry["lm_tp_launches"] = lm_tp.get(entry["name"], 0)
        entry["tp_moe_launches"] = tp_moe.get(entry["name"], 0)
        entry["tp_serve_launches"] = tp_serve.get(entry["name"], 0)
        entry["lm_moe_launches"] = lm_moe.get(entry["name"], 0)
        entry["train_launches"] = train.get(entry["name"], 0)
        entry["tp_train_launches"] = tp_train.get(entry["name"], 0)
        entry["gnn_launches"] = gnn.get(entry["name"], 0)
    emit(phase_walls())
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
