"""Cell assembly on one device: (arch x shape) -> a step function + the
``(shape, dtype)`` of its arguments.

The port's copy of ``repro/launch/steps.py`` without meshes: each
``_build_*`` function returns a :class:`StepBundle` whose ``fn`` runs
eagerly on the tensors it is given (on their device).  The train steps
are the reference's: ``value_and_grad`` of ``lm_loss`` /
``mind_train_loss`` (here
``torch.autograd.grad`` over the parameters' leaves in the reference's
flatten order, :func:`value_and_grad`) then ``adamw_update``, which writes
the new parameters and moments into the given tensors (the reference
donates both).  The LM step accumulates gradients over microbatches of at
most ``REPRO_TORCH_ACCUM_TOKENS`` tokens (8,192 by default; the reference's
``REPRO_ACCUM_TOKENS``), summed in float32 and divided by the count, as
the reference does.  The serve steps wrap ``serve_prefill`` /
``serve_decode`` / ``mind_serve`` / ``mind_retrieval`` under
``torch.inference_mode()``.

Meshes, shardings and the core-graph cell (``_build_coregraph``) wait for
``launch/`` on ``torch.distributed`` (ROADMAP Queue 1 item 7.7);
``_build_gnn`` waits for the GNN models (item 7.6).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from ..configs import get_config
from ..configs.base import LMConfig, RecsysConfig
from ..configs.shapes import input_specs
from ..models import recsys as rec_m
from ..models import transformer as tfm
from ..models.params import requires_grad, tree_map, tree_num_params
from ..optim import AdamWConfig, adamw_state_specs, adamw_update

__all__ = ["StepBundle", "build_step", "default_opt", "value_and_grad",
           "accum_steps"]

F32 = torch.float32
_MESHES = "ROADMAP Queue 1 item 7.7"


@dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple                 # (shape, dtype) trees, positional
    num_params: int = 0
    static: dict | None = None


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"meshes and shardings are not ported yet "
                                  f"({_MESHES}); the port's steps run on "
                                  f"one device")


def _avals(spec_tree):
    return tree_map(lambda s: (tuple(s.shape), s.dtype), spec_tree)


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)``: ``loss_fn(params, *args)`` detached and its
    gradients, one a leaf of ``params`` in the reference's flatten order
    (zeros for a leaf the loss does not reach)."""
    leaves = requires_grad(params)
    with torch.enable_grad():
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def accum_steps(B: int, S: int) -> int:
    """The reference's microbatch count for a (B, S) batch: the largest
    divisor of ``B`` at most ``ceil(B * S / budget)``, the budget being
    ``REPRO_TORCH_ACCUM_TOKENS`` tokens (8,192)."""
    budget = int(os.environ.get("REPRO_TORCH_ACCUM_TOKENS", 8192))
    want = max(1, -(-B * S // budget))
    for cand in range(min(want, B), 0, -1):
        if B % cand == 0:
            return cand
    return 1


# ===================================================================== LM
def _build_lm(cfg: LMConfig, shape_name, step_kind, avals, mesh, opt,
              reduced):
    _no_mesh(mesh)
    pspecs = tfm.lm_param_specs(cfg)
    p_avals = _avals(pspecs)
    n_params = tree_num_params(pspecs)

    if step_kind == "train":
        o_avals = adamw_state_specs(pspecs, opt)
        B, S = avals["tokens"][0]
        accum = accum_steps(B, S)

        def step(params, opt_state, tokens, labels):
            if accum == 1:
                loss, grads = value_and_grad(tfm.lm_loss, params, cfg,
                                             tokens, labels)
            else:
                mb_tok = tokens.reshape(accum, B // accum, S)
                mb_lbl = labels.reshape(accum, B // accum, S)
                grads, loss = None, torch.zeros((), dtype=F32,
                                                device=tokens.device)
                for t, lab in zip(mb_tok, mb_lbl):
                    mb_loss, g = value_and_grad(tfm.lm_loss, params, cfg,
                                                t, lab)
                    if grads is None:
                        grads = [torch.zeros(x.shape, dtype=F32,
                                             device=x.device) for x in g]
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                    del g
                    loss = loss + mb_loss
                for acc in grads:
                    acc.div_(accum)
                loss = loss / accum
            params, opt_state = adamw_update(params, grads, opt_state, opt)
            return params, opt_state, loss

        return StepBundle(
            name="train_step", fn=step,
            args=(p_avals, o_avals, avals["tokens"], avals["labels"]),
            num_params=n_params,
            static={"opt": opt, "cfg": cfg, "accum": accum,
                    "pspecs": pspecs})

    if step_kind == "prefill":
        def step(params, tokens):
            with torch.inference_mode():
                return tfm.serve_prefill(params, cfg, tokens)

        return StepBundle(name="serve_prefill", fn=step,
                          args=(p_avals, avals["tokens"]),
                          num_params=n_params)

    def step(params, tokens, caches):
        with torch.inference_mode():
            return tfm.serve_decode(params, cfg, tokens, caches)

    return StepBundle(name="serve_decode", fn=step,
                      args=(p_avals, avals["tokens"], avals["caches"]),
                      num_params=n_params)


# ===================================================================== GNN
def _build_gnn(cfg, shape_name, step_kind, avals, mesh, opt, reduced):
    raise NotImplementedError("the GNN train step is not ported yet "
                              "(ROADMAP Queue 1 item 7.6)")


# ================================================================== recsys
def _build_recsys(cfg: RecsysConfig, shape_name, step_kind, avals, mesh, opt,
                  reduced):
    _no_mesh(mesh)
    pspecs = rec_m.mind_param_specs(cfg)
    p_avals = _avals(pspecs)
    n_params = tree_num_params(pspecs)

    if step_kind == "train":
        o_avals = adamw_state_specs(pspecs, opt)

        def step(params, opt_state, batch):
            loss, grads = value_and_grad(rec_m.mind_train_loss, params, cfg,
                                         batch)
            params, opt_state = adamw_update(params, grads, opt_state, opt)
            return params, opt_state, loss

        return StepBundle(name="train_step", fn=step,
                          args=(p_avals, o_avals, avals),
                          num_params=n_params,
                          static={"opt": opt, "cfg": cfg, "pspecs": pspecs})

    if step_kind == "serve":
        def step(params, batch):
            with torch.inference_mode():
                return rec_m.mind_serve(params, cfg, batch)

        return StepBundle(name="serve_step", fn=step, args=(p_avals, avals),
                          num_params=n_params)

    def step(params, batch):
        with torch.inference_mode():
            return rec_m.mind_retrieval(params, cfg, batch)

    return StepBundle(name="retrieval_step", fn=step, args=(p_avals, avals),
                      num_params=n_params)


# =============================================================== coregraph
def _build_coregraph(cfg, shape_name, step_kind, avals, mesh, opt, reduced):
    raise NotImplementedError(f"the sharded core-graph step is not ported "
                              f"yet ({_MESHES})")


def default_opt(cfg, quantize_moments: bool | None = None,
                **kw) -> AdamWConfig:
    """The reference's AdamW for ``cfg``: int8 moments for LMs of
    ``d_model >= 7000`` unless ``quantize_moments`` says otherwise; ``kw``
    sets the other fields."""
    if quantize_moments is None:
        quantize_moments = cfg.kind == "lm" and cfg.d_model >= 7000
    return AdamWConfig(quantize_moments=quantize_moments, **kw)


def build_step(arch_id: str, shape_name: str, mesh=None, *,
               reduced: bool = False, opt: AdamWConfig | None = None,
               quantize_moments: bool | None = None,
               depth_override: int | None = None) -> StepBundle:
    """The step of one cell, as the reference's ``build_step`` assembles
    it, on one device (``mesh`` must be None).  AdamW moments are int8
    for LMs of ``d_model >= 7000`` unless ``quantize_moments`` or ``opt``
    says otherwise."""
    _no_mesh(mesh)
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    if depth_override is not None and cfg.kind == "lm":
        cfg = replace(cfg, n_layers=depth_override)
    if opt is None:
        opt = default_opt(cfg, quantize_moments)
    if cfg.kind == "coregraph":
        return _build_coregraph(cfg, shape_name, None, None, mesh, opt,
                                reduced)
    step_kind, avals = input_specs(cfg, shape_name, reduced=reduced)
    build: dict[str, Any] = {"lm": _build_lm, "gnn": _build_gnn,
                             "recsys": _build_recsys}
    return build[cfg.kind](cfg, shape_name, step_kind, avals, mesh, opt,
                           reduced)
