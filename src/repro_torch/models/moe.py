"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The port's copy of ``repro/models/moe.py``.  Dispatch is the production
"dropping" scheme: flatten the (token, k) assignments, sort them by expert
(a stable sort: among equal experts the earlier assignment keeps its
place), keep the first C of each expert (the capacity factor), scatter the
kept tokens into an (experts, C, E) buffer and run the expert FFNs as one
batched product over the expert axis.  Dropped assignments are aimed at a
dummy expert row X with gate 0.  DeepSeek's shared experts and Arctic's
parallel dense residual MLP are added on top.  Plain torch, as the
reference's is plain jnp.

With ``tp`` (a ``layers.TensorParallel`` over the ``model`` axis) the
rank holds experts ``[index * X / M, (index + 1) * X / M)`` and Megatron
pieces of the shared and dense MLPs (``w_gate`` / ``w_up`` by columns,
``w_down`` by rows).  Every rank routes all its tokens with the whole
router, on an input equal on every model rank, and keeps the same first C
assignments of each expert (the positions counted over every expert);
those of experts it does not hold go to its dummy row.  The gated expert
outputs, the shared and the dense partials are added in float32, summed
over ``model`` by one all-reduce and rounded once: no all-to-all.  Under
autograd (training) a rank's gates reach its own experts only, so the
input and the router, whole on every rank, take *f* (``tp.copy_to``):
their gradients are summed over ``model``; the experts' stay local.

With ``dp`` (a ``layers.BatchSplit`` over the mesh's batch axes whose
``rows`` cut the batch) the capacity is the reference's, counted over the
whole batch: ``C`` of the global token count, and each assignment's
position offset by the assignments of its expert on the ranks before this
one in the batch order (one all-gather of the ``(X,)`` counts, integers).
A rank's buffer holds its own kept assignments, ``min(C, T)`` slots an
expert.  ``long_500k``'s one row is whole on every rank (``rows`` false):
its capacity is the rank's own.  Where the experts' embed dimension is cut
over ``dp``'s ranks (``expert_embed``, serving), the weights stay where
the placement puts them and activations move instead (:func:`_expert_ffn`):
each rank takes every rank's buffer rows on its own embed slice, sums its
float32 partial gate and up products with the other ranks' before the one
rounding and the nonlinearity, computes its slice of the output columns
and joins its own rows' columns from the others.  Only the experts that
some rank's tokens reach move, as the gathered counts tell every rank
alike.  Under autograd (training, whose step joins the pieces) that path
raises.
"""
from __future__ import annotations

import torch

from .layers import BatchSplit, TensorParallel, _mm_f32, _tracked, \
    row_partial, swiglu, swiglu_hidden
from .params import Spec

__all__ = ["moe_param_specs", "moe_capacity", "moe_apply"]

F32 = torch.float32


def moe_param_specs(cfg, L: int) -> dict:
    m, E, dt = cfg.moe, cfg.d_model, cfg.dtype
    X, F = m.num_experts, m.d_ff_expert
    sp = {
        "router": Spec((L, E, X), F32, (None, "embed", None)),
        "w_gate": Spec((L, X, E, F), dt, (None, "expert", "expert_embed", None)),
        "w_up": Spec((L, X, E, F), dt, (None, "expert", "expert_embed", None)),
        "w_down": Spec((L, X, F, E), dt, (None, "expert", None, "expert_embed")),
    }
    if m.num_shared:
        Fs = F * m.num_shared
        sp["shared"] = {
            "w_gate": Spec((L, E, Fs), dt, (None, "embed", "mlp")),
            "w_up": Spec((L, E, Fs), dt, (None, "embed", "mlp")),
            "w_down": Spec((L, Fs, E), dt, (None, "mlp", "embed")),
        }
    if m.dense_parallel:
        sp["dense"] = {
            "w_gate": Spec((L, E, cfg.d_ff), dt, (None, "embed", "mlp")),
            "w_up": Spec((L, E, cfg.d_ff), dt, (None, "embed", "mlp")),
            "w_down": Spec((L, cfg.d_ff, E), dt, (None, "mlp", "embed")),
        }
    return sp


def moe_capacity(m, T: int) -> int:
    """Slots of each expert for ``T`` tokens: ``max(8, int(T * k / X *
    capacity_factor))``, in Python floats as the reference computes it."""
    return max(8, int(T * m.top_k / m.num_experts * m.capacity_factor))


def _runs(idx: list) -> list:
    """``idx`` (ascending) cut into runs of consecutive values: ``(a, b,
    slice)``, the run ``idx[a:b]`` and the slice of those values."""
    out, a = [], 0
    for b in range(1, len(idx) + 1):
        if b == len(idx) or idx[b] != idx[b - 1] + 1:
            out.append((a, b, slice(idx[a], idx[b - 1] + 1)))
            a = b
    return out


def _expert_ffn(h, p, dp: BatchSplit | None, used):
    """This rank's experts' SwiGLU on their buffer h (Xl, C, E).

    Where the experts' embed dimension is cut over ``dp``'s D ranks
    (``w_gate`` / ``w_up`` (Xl, E/D, F), ``w_down`` (Xl, F, E/D), this
    rank's slice ``[index * E/D, (index + 1) * E/D)``), only the experts of
    ``used`` (those with an assignment on some rank of ``dp``: every other
    expert's buffer is empty everywhere, and no slot reads its output) are
    computed and moved, their rows of ``h`` first compacted:

    1. with ``dp.rows`` every rank's rows are all-gathered (R = D blocks of
       rows); without, the tokens are alike on every rank (R = 1);
    2. the gate and up products of those rows on this rank's embed slice,
       written in float32 (:func:`layers._mm_f32`), are summed over ``dp``
       by one all-reduce and rounded once, then ``silu(g) * u``;
    3. this rank's E/D columns of the down product for all R blocks (F is
       whole: columns, not partial sums) are all-gathered, and the
       columns of this rank's own block joined.

    The weights never move.  Raises under autograd on such pieces
    (ROADMAP item 8.4.2: the train step joins them first)."""
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    E = h.shape[-1]
    if wg.shape[1] == E:
        return torch.bmm(torch.nn.functional.silu(torch.bmm(h, wg))
                         * torch.bmm(h, wu), wd)
    if _tracked(h) or _tracked(wg):
        raise NotImplementedError(
            "MoE under autograd on expert pieces cut over the batch axes: "
            "the partial products have no backward yet (ROADMAP item 8.4.2)")
    out = torch.zeros_like(h)
    idx = used.nonzero()[:, 0].tolist()
    if not idx:
        return out
    runs = _runs(idx)
    n = wg.shape[1]
    lo = dp.index * n
    hc = h[idx]                                                # (U, C, E)
    U, C = hc.shape[:2]
    blocks = dp.comm.all_gather(hc) if dp.rows else [hc]
    x = torch.stack([b[..., lo:lo + n] for b in blocks], 1).reshape(U, -1, n)
    del blocks
    part = torch.empty((2, U, x.shape[1], wg.shape[-1]), dtype=F32,
                       device=h.device)
    for a, b, s in runs:
        part[0, a:b] = _mm_f32(x[a:b], wg[s])
        part[1, a:b] = _mm_f32(x[a:b], wu[s])
    g, u = dp.comm.all_reduce(part).to(h.dtype)
    del part
    act = torch.nn.functional.silu(g) * u                      # (U, R*C, F)
    cols = torch.empty((U, x.shape[1], n), dtype=h.dtype, device=h.device)
    for a, b, s in runs:
        torch.bmm(act[a:b], wd[s], out=cols[a:b])
    own = dp.index if dp.rows else 0
    cols = cols.reshape(U, -1, C, n)
    out[idx] = torch.cat([c[:, own] for c in dp.comm.all_gather(cols)], -1)
    return out


def moe_apply(p, cfg, x, layer_idx=None, aux=None,
              tp: TensorParallel | None = None,
              dp: BatchSplit | None = None):
    """x (B, S, E) -> (B, S, E).  Dropping top-k dispatch (see module doc);
    ``aux``, a dict, receives the Switch load-balance term.  With ``tp``,
    ``p`` holds this rank's experts and pieces and the output is the sum
    over the ranks; with ``dp``, ``x`` is this rank's rows of a batch cut
    over the batch axes (module doc).  ``aux["dropped"]`` is the count
    of this rank's (token, expert) assignments past the capacity, over
    every expert (an int64 tensor), ``aux["kept"]`` (T, k) whether each
    of them, in its token's top-k order, is within it."""
    m = cfg.moe
    B, S, E = x.shape
    T = B * S
    X, k = m.num_experts, m.top_k
    xt = x.reshape(T, E)
    router = p["router"]
    if tp is not None:  # a rank's gates reach its own experts only
        xt, router = tp.copy_to(xt), tp.copy_to(router)

    logits = xt.to(F32) @ router.to(F32)                       # (T, X)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                 # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(X, device=x.device))
    pos = torch.arange(T * k, device=x.device) - start[sorted_e]
    counts = torch.bincount(flat_e, minlength=X)
    if dp is not None and dp.rows:  # positions in the global token order
        C = moe_capacity(m, T * dp.size)
        every = torch.stack(dp.comm.all_gather(counts))
        keep = pos + every[:dp.index].sum(0)[sorted_e] < C
        counts = every.sum(0)
    else:
        C = moe_capacity(m, T)
        keep = pos < C
    if aux is not None:  # this rank's tokens' assignments past C
        aux["dropped"] = (~keep).sum()
        kept = torch.empty_like(keep)
        kept[order] = keep
        aux["kept"] = kept.reshape(T, k)
    tok = order // k
    if tp is not None:  # this rank's experts, numbered from 0
        Xl = p["w_gate"].shape[0]
        sorted_e = sorted_e - tp.index * Xl
        keep = keep & (sorted_e >= 0) & (sorted_e < Xl)
        counts = counts[tp.index * Xl:(tp.index + 1) * Xl]
    else:
        Xl = X
    slot_e = torch.where(keep, sorted_e, Xl)                   # drop -> dummy
    slot_p = torch.where(keep, pos, 0)

    buf = torch.zeros((Xl + 1, min(C, T), E), dtype=x.dtype, device=x.device)
    buf[slot_e, slot_p] = xt[tok]
    out_buf = _expert_ffn(buf[:Xl], p, dp, counts > 0)         # (Xl, C, E)
    gathered = out_buf[torch.clamp(slot_e, max=Xl - 1), slot_p]  # (T*k, E)
    gate = top_p.reshape(-1)[order] * keep
    if aux is not None:
        # Switch-style load-balance loss terms
        me = probs.mean(dim=0)
        ce = torch.zeros(X, dtype=F32, device=x.device).index_add_(
            0, flat_e, torch.ones(T * k, dtype=F32, device=x.device)) / (T * k)
        aux["load_balance"] = X * torch.sum(me * ce)
    extra = [p[name] for name, on in (("shared", m.num_shared),
                                      ("dense", m.dense_parallel)) if on]
    if tp is not None:  # float32 partials, one sum over the ranks
        y = torch.zeros((T, E), dtype=F32, device=x.device).index_add_(
            0, tok, gathered.to(F32) * gate[:, None])
        for q in extra:
            y = y + row_partial(swiglu_hidden(xt, q["w_gate"], q["w_up"]),
                                q["w_down"])
        return tp.reduce(y).to(x.dtype).reshape(B, S, E)
    y = torch.zeros((T, E), dtype=x.dtype, device=x.device).index_add_(
        0, tok, (gathered.to(F32) * gate[:, None]).to(x.dtype))
    for q in extra:
        y = y + swiglu(xt, q["w_gate"], q["w_up"], q["w_down"])
    return y.reshape(B, S, E)
