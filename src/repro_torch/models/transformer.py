"""LM transformer: GQA (+qk_norm), MLA (DeepSeek), MoE, MTP; train & serve.

The port's copy of ``repro/models/transformer.py``: the parameter specs
(stacked per layer group, under the reference's names and shapes,
DeepSeek's dense prefix group and the multi-token-prediction specs
included), ``lm_forward`` without caches (prefill and training, through
``chunked_attention``) and with them, logits, the cache specs,
``serve_prefill``, one ``serve_decode`` step and the training losses
(``softmax_xent``, ``lm_loss`` and DeepSeek-V3's multi-token prediction).
A Python loop over layers takes the place of ``lax.scan``; where the
reference runs each layer under ``jax.checkpoint``, the cache-free
forward with grad enabled runs each layer under
``torch.utils.checkpoint`` (non-reentrant), so only layer inputs are kept
and each layer is recomputed in the backward.  The recompute routes MoE
tokens as the first pass did: the dispatch's stable sort makes its order
a function of the input alone.  GQA caches keep the reference's layout
``(L, B, T, Hkv, dh)``, MLA's the compressed latent ``(L, B, T, kv_lora)``
and ``(L, B, T, dh_rope)``; both are updated in place where the
reference's ``dynamic_update_slice`` returns new arrays, and ``len`` stays
a device int32 scalar, so a decode step does not wait on the host.  GQA
decode runs ``layers.decode_attention``: the hand-written flash-decode
kernels on CUDA tensors, the reference's einsum form on CPU tensors.  MLA
decode is the reference's weight-absorbed einsum form, plain torch.

Megatron tensor parallelism (``tp``, a ``layers.TensorParallel`` over the
mesh's ``model`` axis; serving, and the dense GQA LMs' training): every
weight is this rank's piece by the reference's rules.  The embedding table is
vocab-parallel (this rank's rows looked up, the rest zero, one all-reduce:
a sum with one non-zero term, exact); ``wq``/``wk``/``wv`` and
``w_gate``/``w_up`` are column-parallel; ``wo`` and ``w_down`` are
row-parallel, their partial products summed in float32 by one all-reduce
and rounded once to the model's dtype; ``lm_head`` is column-parallel and
the logits stay cut by vocab.  The cache-free forward attends this rank's
``H / M`` query heads (``k``/``v`` gathered whole first where M does not
divide ``n_kv``, so a rank's columns cut a head).  Decode gathers this
token's q, k and v, writes k and v on the rank whose sequence piece holds
position ``len`` (a masked write on the device on every rank), and runs
``layers.decode_attention_split``.  MLA (DeepSeek-V3) keeps ``wq_a``,
``wkv_a`` and the norms whole and cuts ``wq_b``, ``wk_b``, ``wv_b`` by
heads and ``wo`` by rows: prefill attends this rank's heads; decode
writes the token's latent and rope key on the rank that holds ``len``,
gathers every head's absorbed query, merges every head's float32
partials over the ranks' latent pieces (``layers.decode_latent_split``)
and keeps its own heads' context.  MoE layers run ``moe.moe_apply`` with
``tp``: this rank's experts, one all-reduce.  Without ``tp`` nothing
changes.

Under autograd (the train step over ``model``) the same forward runs
with Megatron's autograd-aware collectives: *f* (``tp.copy_to``, or
``tp.columns`` fused with the products) on the replicated input of every
column-parallel product (``wq``/``wk``/``wv``, ``w_gate``/``w_up``,
``lm_head``; MLA's ``wq_b`` on the normed ``cq``, ``wk_b``/``wv_b`` on
the normed ``c_kv``, and on the shared rope key, which every local head
reads), on the qk-norm weights, which every rank reads with its own
heads, and in ``moe.moe_apply`` on the MoE input and the router; ``tp.reduce``
(*g*) for the row-parallel sums and the embedding; ``tp.gather`` where M
does not divide ``n_kv``.  So MLA's ``wq_a``, ``wkv_a`` and norms, the
router and MTP's ``proj`` and norms, whole on every rank, get the whole
gradient.  :func:`lm_loss` takes the vocab-parallel :func:`softmax_xent`
on the logits cut by vocab, never joined, MTP's too.  Each layer's
``torch.utils.checkpoint`` recomputes its collectives in the backward, in
the same order on every rank.

With ``dp`` (a ``layers.BatchSplit`` over the mesh's batch axes) a MoE
layer counts its capacity over the whole batch (``moe.moe_apply``).

A decode cache whose sequence is cut over other ranks than the ``model``
axis's (``seq``, a ``layers.SequenceSplit``: ``long_500k``, over every
axis of the mesh) takes the same masked write and split attention on the
ranks of ``seq``, with or without ``tp`` (MLA's latent caches too); with
``tp`` alone the sequence is cut over ``tp``'s ranks.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from .layers import (BatchSplit, SequenceSplit, TensorParallel,
                     chunked_attention,
                     decode_attention, decode_attention_split,
                     decode_latent_split, latent_partial, merge_latent,
                     rms_norm, rope, row_partial, swiglu)
from .moe import moe_apply, moe_param_specs
from .params import Spec, tree_leaves, tree_init

__all__ = ["lm_param_specs", "lm_init", "layer_groups", "attention_block",
           "lm_forward", "lm_logits", "make_kv_cache_specs",
           "make_kv_caches", "serve_prefill", "serve_decode", "softmax_xent",
           "lm_loss"]

F32 = torch.float32


# ---------------------------------------------------------------- param specs
def _attn_specs(cfg: LMConfig, L: int) -> dict:
    E, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cfg.dtype
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq_a": Spec((L, E, m.q_lora), dt, (None, "embed", None)),
            "q_norm": Spec((L, m.q_lora), F32, (None, None), init="ones"),
            "wq_b": Spec((L, m.q_lora, H * (m.dh_nope + m.dh_rope)), dt,
                         (None, None, "heads")),
            "wkv_a": Spec((L, E, m.kv_lora + m.dh_rope), dt,
                          (None, "embed", None)),
            "kv_norm": Spec((L, m.kv_lora), F32, (None, None), init="ones"),
            "wk_b": Spec((L, m.kv_lora, H * m.dh_nope), dt,
                         (None, None, "heads")),
            "wv_b": Spec((L, m.kv_lora, H * m.dh_v), dt,
                         (None, None, "heads")),
            "wo": Spec((L, H * m.dh_v, E), dt, (None, "heads", "embed")),
        }
    sp = {
        "wq": Spec((L, E, H * dh), dt, (None, "embed", "heads")),
        "wk": Spec((L, E, Hkv * dh), dt, (None, "embed", "kv_heads")),
        "wv": Spec((L, E, Hkv * dh), dt, (None, "embed", "kv_heads")),
        "wo": Spec((L, H * dh, E), dt, (None, "heads", "embed")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = Spec((L, dh), F32, (None, None), init="ones")
        sp["k_norm"] = Spec((L, dh), F32, (None, None), init="ones")
    return sp


def _dense_mlp_specs(cfg: LMConfig, L: int) -> dict:
    E, dt = cfg.d_model, cfg.dtype
    return {
        "w_gate": Spec((L, E, cfg.d_ff), dt, (None, "embed", "mlp")),
        "w_up": Spec((L, E, cfg.d_ff), dt, (None, "embed", "mlp")),
        "w_down": Spec((L, cfg.d_ff, E), dt, (None, "mlp", "embed")),
    }


def _layer_group_specs(cfg: LMConfig, L: int, use_moe: bool) -> dict:
    E = cfg.d_model
    g = {
        "attn": _attn_specs(cfg, L),
        "ln_attn": Spec((L, E), F32, (None, "embed"), init="ones"),
        "ln_mlp": Spec((L, E), F32, (None, "embed"), init="ones"),
    }
    if use_moe:
        g["moe"] = moe_param_specs(cfg, L)
    else:
        g["mlp"] = _dense_mlp_specs(cfg, L)
    return g


def layer_groups(cfg: LMConfig) -> list[tuple[str, int, bool]]:
    """[(group name, depth, uses_moe)]; DeepSeek has a dense prefix group."""
    kd = cfg.moe.first_k_dense if cfg.moe is not None else 0
    groups = []
    if kd:
        groups.append(("layers0", kd, False))
    groups.append(("layers", cfg.n_layers - kd, cfg.moe is not None))
    return groups


def lm_param_specs(cfg: LMConfig) -> dict:
    E, dt = cfg.d_model, cfg.dtype
    specs = {
        "embed": Spec((cfg.vocab, E), dt, ("vocab", "embed"), scale=1.0),
        "ln_f": Spec((E,), F32, ("embed",), init="ones"),
        "lm_head": Spec((E, cfg.vocab), dt, ("embed", "vocab")),
    }
    for name, depth, use_moe in layer_groups(cfg):
        specs[name] = _layer_group_specs(cfg, depth, use_moe)
    if cfg.mtp_depth > 0:
        D = cfg.mtp_depth
        specs["mtp"] = {
            "proj": Spec((D, 2 * E, E), dt, (None, "embed", None)),
            "ln_in": Spec((D, E), F32, (None, "embed"), init="ones"),
            "ln_prev": Spec((D, E), F32, (None, "embed"), init="ones"),
            "mlp": _dense_mlp_specs(cfg, D),
        }
    return specs


def lm_init(cfg: LMConfig, generator: torch.Generator):
    """The LM's parameters on ``generator.device``, drawn from it."""
    return tree_init(lm_param_specs(cfg), generator)


# ------------------------------------------------------------------- attention
def _gqa_qkv(p, cfg: LMConfig, x, positions):
    B, S, E = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh)
    q, k = _qk_rope(p, cfg, q, k, positions)
    return q, k, v


def _qk_rope(p, cfg: LMConfig, q, k, positions, tp=None):
    """qk_norm (per head) and RoPE on q (B, S, h, dh) and k (B, S, hkv,
    dh); with ``tp`` the norms' weights (whole on every rank, read by this
    rank's heads) get their gradient summed over the ranks."""
    if cfg.qk_norm:
        wq, wk = p["q_norm"], p["k_norm"]
        if tp is not None:
            wq, wk = tp.copy_to(wq), tp.copy_to(wk)
        q = rms_norm(q, wq)
        k = rms_norm(k, wk)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k


def _mla_q(p, cfg: LMConfig, x, positions, tp=None):
    """MLA's queries of the heads ``p["wq_b"]`` holds (all, or a rank's
    columns of whole heads): q_nope (B, S, h, dh_nope) and q_rope (B, S,
    h, dh_rope), roped.  With ``tp`` the normed ``cq`` (whole on every
    rank) gets its gradient summed over the ranks."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rms_norm(x @ p["wq_a"], p["q_norm"])
    q, = (cq @ p["wq_b"],) if tp is None else tp.columns(cq, p["wq_b"])
    q = q.reshape(B, S, -1, m.dh_nope + m.dh_rope)
    return q[..., :m.dh_nope], rope(q[..., m.dh_nope:], positions,
                                    cfg.rope_theta)


def _mla_latent(p, cfg: LMConfig, x, positions, tp=None):
    """The compressed latent ``c_kv`` (B, S, kv_lora) and the roped key
    ``k_rope`` (B, S, 1, dh_rope), one for all heads; with ``tp`` the
    rope key's gradient summed over the ranks (every rank's heads read
    it)."""
    m = cfg.mla
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :m.kv_lora], p["kv_norm"])
    k_rope = kv_a[:, :, None, m.kv_lora:]
    if tp is not None:
        k_rope = tp.copy_to(k_rope)
    return c_kv, rope(k_rope, positions, cfg.rope_theta)


def _mla_qkv_full(p, cfg: LMConfig, x, positions, tp=None):
    """MLA decompressed form (prefill: full per-head k, v; the rope key,
    one for all heads, broadcast) of the heads the ``wq_b``, ``wk_b`` and
    ``wv_b`` given hold; with ``tp`` the column-parallel ``wq_b``,
    ``wk_b`` and ``wv_b`` read ``cq`` and ``c_kv`` through *f*."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, cfg, x, positions, tp)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions, tp)
    h = q_nope.shape[2]
    k_nope, v = (c_kv @ p["wk_b"], c_kv @ p["wv_b"]) if tp is None else \
        tp.columns(c_kv, p["wk_b"], p["wv_b"])
    k_nope = k_nope.reshape(B, S, h, m.dh_nope)
    v = v.reshape(B, S, h, m.dh_v)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.dh_rope)], dim=-1)
    return q, k, v


def _mla_scale(cfg: LMConfig) -> float:
    return 1.0 / ((cfg.mla.dh_nope + cfg.mla.dh_rope) ** 0.5)


def _mla_decode(p, cfg: LMConfig, x, positions, cache):
    """Latent-cache decode with weight absorption: writes this step's
    latent ``c_kv`` and rope key into the caches ``(B, T, kv_lora)`` and
    ``(B, T, dh_rope)`` in place; the scores and the latent context in
    float32 (:func:`layers.latent_partial` over the whole cache as one
    piece)."""
    m = cfg.mla
    B, S, _ = x.shape            # S == new tokens (1 for decode)
    H = cfg.n_heads
    ckv_c, kr_c, length = cache
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    # in place of dynamic_update_slice: positions len .. len+S-1
    pos = (length + torch.arange(S, device=x.device)).long()
    ckv_c.index_copy_(1, pos, c_kv.to(ckv_c.dtype))
    kr_c.index_copy_(1, pos, k_rope[:, :, 0].to(kr_c.dtype))
    # absorb wk_b into q: q_abs (B,S,H,kvl)
    wk = p["wk_b"].reshape(m.kv_lora, H, m.dh_nope)
    q_abs = torch.einsum("bshn,khn->bshk", q_nope, wk)
    ml, ctx = latent_partial(q_abs, q_rope, ckv_c, kr_c, length + S, 0,
                             _mla_scale(cfg))
    ctx = merge_latent(ml[None], ctx[None])                    # latent context
    wv = p["wv_b"].reshape(m.kv_lora, H, m.dh_v)
    out = torch.einsum("bshk,khv->bshv", ctx, wv.to(F32))
    out = out.reshape(B, S, H * m.dh_v).to(x.dtype)
    return out @ p["wo"]


def _mla_decode_split(p, cfg: LMConfig, x, positions, cache,
                      seq: SequenceSplit, tp: TensorParallel | None = None):
    """:func:`_mla_decode` over latent caches whose sequence is cut over
    the ranks of ``seq`` (``cache``: this rank's pieces and ``len``), one
    token a step.  The token's latent and rope key are written on the rank
    that holds position ``len``; with ``tp`` each rank forms the absorbed
    queries of its own heads and one all-gather over ``model`` gives every
    rank all of them.  Each rank's float32 partials for every head over
    its pieces are merged over ``seq`` (:func:`layers.decode_latent_split`);
    a rank keeps its heads of the latent context, applies its ``wv_b``
    and ``wo`` (row-parallel) pieces."""
    m = cfg.mla
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode over a split sequence takes one token a "
                         f"step, got {S}")
    ckv_c, kr_c, length = cache
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    _write_owned(ckv_c, c_kv, length, seq)
    _write_owned(kr_c, k_rope[:, :, 0], length, seq)
    h = q_nope.shape[2]
    wk = p["wk_b"].reshape(m.kv_lora, h, m.dh_nope)
    q = torch.cat([torch.einsum("bshn,khn->bshk", q_nope, wk), q_rope], -1)
    if tp is not None:  # every head's absorbed query on every rank
        q = torch.cat(tp.comm.all_gather(q), dim=2)
    ctx = decode_latent_split(q[..., :m.kv_lora], q[..., m.kv_lora:], ckv_c,
                              kr_c, length + 1, seq, _mla_scale(cfg))
    if tp is not None:
        ctx = ctx[:, :, tp.index * h:(tp.index + 1) * h]
    wv = p["wv_b"].reshape(m.kv_lora, h, m.dh_v)
    out = torch.einsum("bshk,khv->bshv", ctx, wv.to(F32))
    out = out.reshape(B, S, h * m.dh_v).to(x.dtype)
    return out @ p["wo"] if tp is None else _row_parallel(out, p["wo"], tp)


def attention_block(p, cfg: LMConfig, x, positions, cache=None, tp=None,
                    seq=None):
    """The attention output.  Without ``cache``: the cache-free form over
    the whole sequence (``chunked_attention``, causal).  With it: ``cache``
    is the layer's caches in :func:`make_kv_cache_specs` order and ``len``,
    a device int32 scalar (GQA ``(k_cache, v_cache, len)``, caches (B, T,
    Hkv, dh); MLA ``(ckv_cache, kr_cache, len)``); this step's entries are
    written into them in place.  With ``tp``: :func:`_attention_tp`; with
    ``seq`` alone the caches are this rank's sequence pieces
    (:func:`_split_decode`, MLA :func:`_mla_decode_split`)."""
    if tp is not None:
        return _attention_tp(p, cfg, x, positions, cache, tp, seq)
    B, S, _ = x.shape
    if cache is not None and cfg.mla is not None:
        if seq is not None:
            return _mla_decode_split(p, cfg, x, positions, cache, seq)
        return _mla_decode(p, cfg, x, positions, cache)
    qkv = _mla_qkv_full if cfg.mla is not None else _gqa_qkv
    q, k, v = qkv(p, cfg, x, positions)
    if cache is None:
        out = chunked_attention(q, k, v, causal=True)
        return out.reshape(B, S, -1) @ p["wo"]
    if seq is not None:
        out = _split_decode(q, k, v, cache, seq)
        return out.reshape(B, S, -1) @ p["wo"]
    k_cache, v_cache, length = cache
    # in place of dynamic_update_slice: positions len .. len+S-1
    pos = (length + torch.arange(S, device=x.device)).long()
    k_cache.index_copy_(1, pos, k.to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, length + S)
    return out.reshape(B, S, -1) @ p["wo"]


# ------------------------------------------------------ tensor parallelism
def _row_parallel(h, w, tp: TensorParallel):
    """``h @ w`` for a row-parallel ``w``: this rank's float32 partial
    product (:func:`layers.row_partial`), summed over the ranks by one
    all-reduce, rounded once to ``h``'s dtype."""
    return tp.reduce(row_partial(h, w)).to(h.dtype)


def _kv_of_heads(k, v, heads: list):
    """k, v (B, S, n, dh) narrowed to the kv heads of the query heads
    ``heads`` (indices into n, in query-head order): a run of whole GQA
    groups where they form one, else one kv head a query head."""
    nh, first = len(heads), heads[0]
    n = heads[-1] - first + 1
    if nh % n == 0 and heads == [first + j // (nh // n) for j in range(nh)]:
        return k[:, :, first:first + n], v[:, :, first:first + n]
    return k[:, :, heads], v[:, :, heads]


def _write_owned(cache, new, length, seq: SequenceSplit) -> None:
    """Write ``new`` (B, 1, ...) at position ``length`` of the sequence
    into this rank's piece ``cache`` (B, T, ...: GQA's (Hkv, dh), MLA's
    latent or rope key), which holds
    positions ``[seq.index * T, (seq.index + 1) * T)``: a masked write on
    the device (a clamped local index; the old entry written back where
    the position is not this rank's), so no rank reads ``length`` on the
    host."""
    T = cache.shape[1]
    local = length.long() - seq.index * T
    own = (local >= 0) & (local < T)
    idx = local.clamp(0, T - 1).reshape(1)
    cache.index_copy_(1, idx, torch.where(own, new.to(cache.dtype),
                                          cache.index_select(1, idx)))


def _split_decode(q, k, v, cache, seq: SequenceSplit,
                  tp: TensorParallel | None = None):
    """One token's attention over this rank's sequence pieces ``cache``
    (``(k_cache, v_cache, len)``): every head's q (B, 1, H, dh), k and v
    (B, 1, Hkv, dh); k and v written on the rank of ``seq`` that holds
    position ``len``, then :func:`layers.decode_attention_split` (with
    ``tp``, this rank's heads of it)."""
    if q.shape[1] != 1:
        raise ValueError(f"decode over a split sequence takes one token a "
                         f"step, got {q.shape[1]}")
    k_cache, v_cache, length = cache
    _write_owned(k_cache, k, length, seq)
    _write_owned(v_cache, v, length, seq)
    return decode_attention_split(q, k_cache, v_cache, length + 1, seq, tp)


def _attention_tp(p, cfg: LMConfig, x, positions, cache, tp: TensorParallel,
                  seq: SequenceSplit | None = None):
    """Attention with this rank's weight pieces: column-parallel
    ``wq``/``wk``/``wv`` (MLA: ``wq_b``/``wk_b``/``wv_b``, whole heads;
    ``wq_a``, ``wkv_a`` and the norms whole), row-parallel ``wo``.
    Without ``cache``, the causal ``chunked_attention`` of this rank's
    ``H / M`` query heads.  With it (one token) the cache is cut over the
    ranks of ``seq`` (by default the sequence cut over ``tp``'s ranks):
    GQA gathers every head's q, k, v and runs :func:`_split_decode`; MLA
    runs :func:`_mla_decode_split`."""
    B, S, _ = x.shape
    seq = seq or SequenceSplit(tp.comm, tp.size, tp.index)
    if cfg.mla is not None:
        if cache is not None:
            return _mla_decode_split(p, cfg, x, positions, cache, seq, tp)
        q, k, v = _mla_qkv_full(p, cfg, x, positions, tp)
        out = chunked_attention(q, k, v, causal=True)
        return _row_parallel(out.reshape(B, S, -1), p["wo"], tp)
    H, Hkv, dh, M = cfg.n_heads, cfg.n_kv, cfg.head_dim, tp.size
    nh = H // M
    q, k, v = tp.columns(x, p["wq"], p["wk"], p["wv"])
    if cache is not None:
        # one gather: every rank's q, k and v columns side by side
        nq, nk = q.shape[-1], k.shape[-1]
        parts = tp.comm.all_gather(torch.cat([q, k, v], dim=-1))
        q, k, v = (torch.cat([part[..., a:b] for part in parts], dim=-1)
                   for a, b in ((0, nq), (nq, nq + nk), (nq + nk, None)))
        q, k = _qk_rope(p, cfg, q.reshape(B, S, H, dh),
                        k.reshape(B, S, Hkv, dh), positions, tp)
        out = _split_decode(q, k, v.reshape(B, S, Hkv, dh), cache, seq, tp)
    else:
        if Hkv % M:  # this rank's columns cut a kv head: k, v whole
            k, v = tp.gather(k), tp.gather(v)
            kv0 = 0
        else:
            kv0 = tp.index * (Hkv // M)
        q, k = _qk_rope(p, cfg, q.reshape(B, S, nh, dh),
                        k.reshape(B, S, -1, dh), positions, tp)
        v = v.reshape(B, S, -1, dh)
        G = H // Hkv
        k, v = _kv_of_heads(k, v, [(tp.index * nh + j) // G - kv0
                                   for j in range(nh)])
        out = chunked_attention(q, k, v, causal=True)
    return _row_parallel(out.reshape(B, S, -1), p["wo"], tp)


def _embed(params, cfg: LMConfig, tokens, tp=None):
    """The tokens' embeddings; with ``tp`` from this rank's rows of the
    vocab-parallel table, summed over the ranks."""
    if tp is None:
        return params["embed"][tokens.long()].to(cfg.dtype)
    table = params["embed"]
    rows = table.shape[0]
    ids = tokens.long() - tp.index * rows
    mine = (ids >= 0) & (ids < rows)
    x = torch.where(mine[..., None], table[ids.clamp(0, rows - 1)].float(),
                    0.0)
    return tp.reduce(x).to(cfg.dtype)


# ------------------------------------------------------------------- layers
def _dense_mlp(p, x, tp=None):
    if tp is None:
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    gate, up = tp.columns(x, p["w_gate"], p["w_up"])
    return _row_parallel(torch.nn.functional.silu(gate) * up, p["w_down"],
                         tp)


def _layer_slice(gp, i: int) -> dict:
    """Layer ``i``'s parameters of a stacked group (views)."""
    return {k: _layer_slice(v, i) if not isinstance(v, torch.Tensor) else v[i]
            for k, v in ((k, gp[k]) for k in gp.keys())}


def _layer(cfg: LMConfig, x, lp, positions, use_moe: bool, cache=None,
           tp=None, seq=None, dp=None):
    a = attention_block(lp["attn"], cfg, rms_norm(x, lp["ln_attn"]), positions,
                        cache, tp, seq)
    x = x + a
    h = rms_norm(x, lp["ln_mlp"])
    f = moe_apply(lp["moe"], cfg, h, tp=tp, dp=dp) if use_moe else \
        _dense_mlp(lp["mlp"], h, tp)
    return x + f


def lm_forward(params, cfg: LMConfig, tokens, positions=None, caches=None,
               tp=None, seq=None, dp: BatchSplit | None = None):
    """tokens (B, S) -> (hidden (B, S, E), caches).  Without ``caches`` the
    cache-free forward (prefill, training), returning ``None`` for them,
    each layer under activation checkpointing when grad is enabled; with
    them (:func:`make_kv_caches`, under any keys beside ``len``) each
    layer's entries are written in place and ``len`` advanced.  With
    ``tp`` the params and caches are this rank's pieces, with ``seq`` the
    caches' sequence pieces over its ranks, with ``dp`` the batch axes'
    ranks of the MoE capacity (module docstring)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed(params, cfg, tokens, tp)
    length = None if caches is None else caches["len"]
    cache_keys = [] if caches is None else [k for k in caches if k != "len"]
    offset = 0
    for name, depth, use_moe in layer_groups(cfg):
        gp = params[name]
        remat = caches is None and torch.is_grad_enabled() and any(
            t.requires_grad for _, t in tree_leaves(gp))
        for i in range(depth):
            if remat:
                x = checkpoint(_layer, cfg, x, _layer_slice(gp, i),
                               positions, use_moe, None, tp, None, dp,
                               use_reentrant=False)
                continue
            cache = None if caches is None else (
                *(caches[k][offset + i] for k in cache_keys), length)
            x = _layer(cfg, x, _layer_slice(gp, i), positions, use_moe, cache,
                       tp, seq, dp)
        offset += depth
    if caches is not None:
        caches["len"] = length + S
    return rms_norm(x, params["ln_f"]), caches


def lm_logits(params, cfg: LMConfig, hidden):
    return hidden @ params["lm_head"]


# ---------------------------------------------------------------------- steps
def softmax_xent(logits, labels, tp=None):
    """Mean next-token cross entropy, log-softmax in float32.  With ``tp``
    the logits are this rank's vocab columns ``[index * V, (index + 1) *
    V)`` and are never joined: the rows' max over every rank (a constant
    to autograd), the log of their exponentials summed over the ranks,
    and each label's logit from the rank that holds its column."""
    if tp is None:
        logp = torch.log_softmax(logits.to(F32), dim=-1)
        ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        return -ll.mean()
    z = logits.to(F32)
    V = z.shape[-1]
    top = tp.max(z.amax(dim=-1))
    lse = top + torch.log(tp.reduce(torch.exp(z - top[..., None]).sum(-1)))
    local = labels.long() - tp.index * V
    mine = (local >= 0) & (local < V)
    picked = torch.gather(z, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    ll = tp.reduce(torch.where(mine, picked, 0.0))
    return (lse - ll).mean()


def _head_logits(params, cfg: LMConfig, hidden, tp=None):
    """The logits of ``hidden``; with ``tp`` this rank's vocab columns,
    ``hidden`` (whole on every rank) read through *f*."""
    if tp is None:
        return lm_logits(params, cfg, hidden)
    return tp.columns(hidden, params["lm_head"])[0]


def lm_loss(params, cfg: LMConfig, tokens, labels, tp=None,
            dp: BatchSplit | None = None):
    """The training loss; with ``tp`` on this rank's weight pieces, the
    logits cut by vocab (:func:`softmax_xent`), MTP's too; with ``dp``
    this rank's rows of a batch cut over the batch axes (the MoE
    capacity counted over all of them)."""
    hidden, _ = lm_forward(params, cfg, tokens, tp=tp, dp=dp)
    loss = softmax_xent(_head_logits(params, cfg, hidden, tp), labels, tp)
    if cfg.mtp_depth > 0:
        loss = loss + 0.3 * _mtp_loss(params, cfg, hidden, tokens, labels, tp)
    return loss


def _mtp_loss(params, cfg: LMConfig, hidden, tokens, labels, tp=None):
    """DeepSeek-V3 multi-token prediction: chained extra-depth
    predictions.  With ``tp`` the rolled tokens' embedding is
    vocab-parallel, the MLP Megatron-split and the logits cut by vocab;
    ``proj`` and the norms stay whole."""
    mtp = params["mtp"]
    h = hidden
    total = 0.0
    for d in range(cfg.mtp_depth):
        nxt = torch.roll(tokens, -(d + 1), dims=1)
        e = _embed(params, cfg, nxt, tp)
        h = torch.cat([rms_norm(h, mtp["ln_prev"][d]),
                       rms_norm(e, mtp["ln_in"][d])], dim=-1) @ mtp["proj"][d]
        h = h + _dense_mlp(_layer_slice(mtp["mlp"], d), h, tp)
        total = total + softmax_xent(
            _head_logits(params, cfg, h, tp),
            torch.roll(labels, -(d + 1), dims=1), tp)
    return total / cfg.mtp_depth


def make_kv_cache_specs(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """Decode-cache ``(shape, dtype)`` of each entry; MLA uses the
    compressed latent cache."""
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": ((L, batch, max_len, m.kv_lora), cfg.dtype),
                "kr": ((L, batch, max_len, m.dh_rope), cfg.dtype),
                "len": ((), torch.int32)}
    kv = ((L, batch, max_len, cfg.n_kv, cfg.head_dim), cfg.dtype)
    return {"k": kv, "v": kv, "len": ((), torch.int32)}


def make_kv_caches(cfg: LMConfig, batch: int, max_len: int, device) -> dict:
    """Zeroed caches on ``device``."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in
            make_kv_cache_specs(cfg, batch, max_len).items()}


def serve_prefill(params, cfg: LMConfig, tokens, tp=None,
                  dp: BatchSplit | None = None):
    """The prefill cell's step: tokens (B, S) -> the last position's
    logits (B, 1, vocab), through the cache-free forward (with ``tp``:
    this rank's vocab columns; with ``dp``: this rank's rows of the
    batch)."""
    hidden, _ = lm_forward(params, cfg, tokens, tp=tp, dp=dp)
    return lm_logits(params, cfg, hidden[:, -1:, :])


def serve_decode(params, cfg: LMConfig, tokens, caches, tp=None, seq=None,
                 dp: BatchSplit | None = None):
    """One decode step: tokens (B, 1) + caches -> (logits, caches), the
    caches updated in place (with ``tp``: this rank's weight pieces and
    vocab columns; with ``tp`` or ``seq``: this rank's cache pieces; with
    ``dp``: the batch axes' ranks of the MoE capacity and of the experts'
    embed pieces)."""
    B = tokens.shape[0]
    positions = caches["len"].reshape(1, 1).expand(B, 1)
    hidden, caches = lm_forward(params, cfg, tokens, positions, caches, tp,
                                seq, dp)
    return lm_logits(params, cfg, hidden), caches
