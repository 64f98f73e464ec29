"""Dry run: every (arch x shape) cell's step on the production meshes,
sized and counted without a card and without a process group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch yi-34b
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all, both

The port's counterpart of ``repro/launch/dryrun.py``: the 41 cells (every
arch's shapes plus ``semicore-webscale/decompose``) on the 256-chip
``(16, 16)`` and 512-chip ``(2, 16, 16)`` meshes.  For each it writes one
JSON record under ``--out`` (``dryrun_out/`` at the repository root by
default, git-ignored):

* **per-chip bytes** from the step's placements (:func:`args_bytes_per_chip`
  and :func:`memory_model`, the reference's ``_args_bytes_per_chip`` and
  ``_memory_model``), held against the H100's 80 GB; for the core-graph
  cell the replicated node state, ``n x 4 B`` a chip (the paper's
  Clueweb check: 3.9 GB);
* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over the
  step run on ``meta`` tensors on one device (the global step: its
  matmul-like ops; the hand-written kernels take their plain versions on
  ``meta``), with the reference's depth extrapolation for LMs (depths
  ``d0`` and ``d0 + 1``, linear to the config's) and one microbatch; a
  chip's share is the total over the mesh's chips.  The core-graph
  superstep has no matmul: 0;
* **collective bytes**, a model from the placements, where the reference
  read its compiled HLO: for an LM or MIND train step over k > 1 batch
  shards, the data-parallel gradient all-reduce (2 x its float32
  gradient bytes a chip x (k - 1) / k, a ring) and the all-gather that
  rebuilds each parameter from the ranks' ZeRO-1 updates ((k - 1) / k of
  the parameter's bytes a chip, whole over the batch axes: every leaf with
  int8 moments, and with float32 moments every leaf replicated over the
  batch axes whose moments are cut there); the core-graph superstep's
  all-gather of the ``n x 4 B`` core plus its 4 B frontier count.
  Tensor-parallel collectives, the experts' embed pieces joined for the
  forward and the GNN's all-reduced edge sums are not modelled;
* **roofline** against the H100 SXM data-sheet peaks at 700 W: 989 TFLOP/s
  dense bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from math import prod
from pathlib import Path

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES_BY_KIND, shape_names
from ..models.params import tree_leaves
from .mesh import make_production_mesh
from .steps import _zip_map, build_step

__all__ = ["all_cells", "args_bytes_per_chip", "memory_model", "run_cell",
           "step_flops", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"

# H100 SXM data-sheet figures at 700 W
PEAK_FLOPS = 989e12         # dense bf16 / chip
HBM_BW = 3.35e12            # B/s / chip
NVLINK_BW = 450e9           # B/s / chip, each way
HBM_BYTES = 80e9


def all_cells() -> list:
    cells = [(arch, shape) for arch in ARCH_IDS
             for shape in shape_names(get_config(arch))]
    cells.append(("semicore-webscale", "decompose"))
    return cells


def _pairs(avals, shardings) -> list:
    """(``(shape, dtype)``, Sharding) of every leaf of an argument."""
    out: list = []
    _zip_map(lambda a, s: out.append((a, s)), avals, shardings)
    return out


def args_bytes_per_chip(bundle) -> float:
    """Per-chip bytes of every step argument (params, optimizer state,
    caches, batch) under its placement (0 where the bundle has none)."""
    if bundle.in_shardings is None:
        return 0.0
    total = 0.0
    for avals, sh in zip(bundle.args, bundle.in_shardings):
        for (shape, dtype), s in _pairs(avals, sh):
            total += prod(shape) * dtype.itemsize / s.frac
    return total


def memory_model(arch, shape, mesh, bundle, chips) -> dict:
    """Analytic per-chip memory (the reference's ``_memory_model``, held
    against the H100's 80 GB)."""
    cfg = get_config(arch)
    args = args_bytes_per_chip(bundle)
    act = 0.0
    grads = 0.0
    if cfg.kind == "coregraph":
        # replicated node state (core in + gathered out) + the chip's edge
        # shard (dst/rows/mask) + its owned-slot state (ids/mask/lsegptr/
        # cnt/active)
        args = 2 * cfg.n * 4 + cfg.m_directed / chips * 9 \
            + cfg.n / chips * 14
        act = cfg.m_directed / chips * 8  # gathered nbr cores + indices
    elif bundle.name == "train_step" and cfg.kind == "lm":
        accum = bundle.static.get("accum", 1)
        sh = SHAPES_BY_KIND["lm"][shape]
        ba_shards = chips // mesh.shape.get("model", 1)
        tok_chip = sh["global_batch"] * sh["seq_len"] / ba_shards / accum
        # checkpointing keeps one (tokens, d_model) bf16 a layer + ~8x
        act = tok_chip * cfg.d_model * 2 * (cfg.n_layers + 8)
        grads = bundle.num_params * 4 / chips  # fp32 grads, fully sharded
    elif bundle.name == "train_step":
        act = args * 4  # GNN/recsys: a few activation-sized buffers
        grads = bundle.num_params * 4  # replicated small models
    else:
        act = args * 0.25
    total = args + act + grads
    return {
        "args_bytes_per_chip": args,
        "activation_bytes_per_chip": act,
        "grad_bytes_per_chip": grads,
        "total_bytes_per_chip": total,
        "fits_80GB_hbm": bool(total < HBM_BYTES * 0.92),
    }


def _meta(avals):
    """``meta`` tensors of a ``(shape, dtype)`` tree (params under grad
    get ``requires_grad`` in the step itself)."""
    if isinstance(avals, tuple) and len(avals) == 2 and isinstance(
            avals[0], tuple):
        shape, dtype = avals
        return torch.empty(shape, dtype=dtype, device="meta")
    if isinstance(avals, dict):
        return {k: _meta(v) for k, v in avals.items()}
    return avals


def step_flops(arch: str, shape: str, *, reduced: bool = False,
               depth: int | None = None) -> float:
    """FLOPs of one global step of the cell on ``meta`` tensors (one
    microbatch), counted by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    saved = os.environ.get("REPRO_TORCH_ACCUM_TOKENS")
    os.environ["REPRO_TORCH_ACCUM_TOKENS"] = str(10 ** 9)
    try:
        b = build_step(arch, shape, reduced=reduced, depth_override=depth)
    finally:
        if saved is None:
            del os.environ["REPRO_TORCH_ACCUM_TOKENS"]
        else:
            os.environ["REPRO_TORCH_ACCUM_TOKENS"] = saved
    args = [_meta(a) for a in b.args]
    if b.name == "train_step":
        from ..optim import adamw_init

        args[1] = adamw_init(args[0], b.static["opt"])
    counter = FlopCounterMode(display=False)
    with counter:
        b.fn(*args)
    return float(counter.get_total_flops())


def cell_flops(arch: str, shape: str, reduced: bool = False) -> tuple:
    """``(flops of one global step, extrapolated)``: LMs from two shallow
    depths, linear in depth to the config's (the reference's
    extrapolation); other families as they are; the core-graph superstep
    0 (no matmul)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.kind == "coregraph":
        return 0.0, False
    if cfg.kind != "lm":
        return step_flops(arch, shape, reduced=reduced), False
    kd = cfg.moe.first_k_dense if cfg.moe is not None else 0
    d0 = kd + 1
    f0 = step_flops(arch, shape, reduced=reduced, depth=d0)
    f1 = step_flops(arch, shape, reduced=reduced, depth=d0 + 1)
    delta = f1 - f0
    if delta <= 0:
        delta = f1 / (d0 + 1)
    return f0 + (cfg.n_layers - d0) * delta, True


def collective_bytes(bundle, mesh, cfg) -> dict:
    """The modelled per-chip collective bytes of one step."""
    out = {"all-gather": 0.0, "all-reduce": 0.0}
    if cfg.kind == "coregraph":
        out["all-gather"] = float(cfg.n * 4)
        out["all-reduce"] = 4.0
    elif bundle.name == "train_step" and cfg.kind in ("lm", "recsys"):
        ba = tuple(a for a in mesh.axis_names if a != "model")
        k = mesh.axis_size(ba)
        q8 = bundle.static["opt"].quantize_moments
        m_sh = dict(tree_leaves(bundle.in_shardings[1]["mu"]))
        grad = gathered = 0.0
        for (name, (shape, dt)), (_, p) in zip(
                tree_leaves(bundle.args[0]),
                tree_leaves(bundle.in_shardings[0])):
            grad += prod(shape) * 4 / p.frac
            if q8 or m_sh[name + ".m"].frac > p.frac:
                # the leaf whole over the batch axes, this chip's model piece
                over_ba = prod(mesh.axis_size(p.dim_axes(d))
                               for d in range(len(shape))
                               if set(p.dim_axes(d)) <= set(ba))
                gathered += prod(shape) * dt.itemsize / p.frac * over_ba
        out["all-reduce"] = 2.0 * grad * (k - 1) / k
        out["all-gather"] = gathered * (k - 1) / k
    out["total"] = out["all-gather"] + out["all-reduce"]
    return out


def run_cell(arch: str, shape: str, mesh, mesh_name: str, chips: int, *,
             reduced: bool = False, flops: tuple | None = None) -> dict:
    """One cell's record on ``mesh`` (``flops``: a ``cell_flops`` result
    to reuse across meshes)."""
    t0 = time.time()
    bundle = build_step(arch, shape, mesh, reduced=reduced)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    build_s = time.time() - t0
    total, extrapolated = flops if flops is not None else cell_flops(
        arch, shape, reduced)
    per_chip = total / chips
    mem = memory_model(arch, shape, mesh, bundle, chips)
    coll = collective_bytes(bundle, mesh, cfg)
    compute_s = per_chip / PEAK_FLOPS
    memory_s = mem["total_bytes_per_chip"] / HBM_BW
    collective_s = coll["total"] / NVLINK_BW
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "step": bundle.name, "num_params": bundle.num_params, "ok": True,
        "reduced": reduced, "extrapolated_depth_metrics": extrapolated,
        "build_s": round(build_s, 3), "seconds": round(time.time() - t0, 3),
        "memory_model": mem,
        "flops_total": total, "flops_per_chip": per_chip,
        "collective_bytes_per_chip": coll,
        "roofline": {"compute_s": compute_s, "memory_s": memory_s,
                     "collective_s": collective_s, "dominant": dominant,
                     "peaks": "H100 SXM data sheet, 700 W"},
    }
    if cfg.kind == "coregraph":
        rec["node_state_bytes_per_chip"] = cfg.n * 4
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a quick check)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh(), 256))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True), 512))
    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    failures = 0
    flops: dict = {}
    for mesh_name, mesh, chips in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{mesh_name}"
            print(f"[run ] {tag}", flush=True)
            try:
                if (arch, shape) not in flops:
                    flops[arch, shape] = cell_flops(arch, shape, args.reduced)
                rec = run_cell(arch, shape, mesh, mesh_name, chips,
                               reduced=args.reduced,
                               flops=flops[arch, shape])
            except Exception as e:  # a record per cell, as the reference's
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"[FAIL] {tag}: {rec['error']}", flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("ok"):
                r = rec["roofline"]
                print(f"[ ok ] {tag} flops/chip={rec['flops_per_chip']:.3g} "
                      f"bytes/chip={rec['memory_model']['total_bytes_per_chip']:.3g} "
                      f"dom={r['dominant']}", flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
