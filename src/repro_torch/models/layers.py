"""Shared neural layers: RMSNorm, RoPE, SwiGLU, the chunked attention of
the cache-free forward and the one-token decode attention.

The port's copy of ``repro/models/layers.py`` (``rms_norm``, ``rope``,
``swiglu``, ``chunked_attention``, ``decode_attention``).
``decode_attention`` on CUDA tensors runs the hand-written flash-decode
kernels (``kernels/flash_decode.py``), the single-chip form the reference
names for it; on CPU tensors it runs the reference's einsum form.
``chunked_attention`` is plain torch, as the reference's is plain jnp: a
Python loop over KV chunks in place of ``lax.scan``, in place for
serving and out of place where autograd differentiates it (training).

``decode_attention_split`` is the decode attention over a cache whose
sequence is cut over the ranks of a :class:`SequenceSplit` (the
``model`` axis of a mesh for ``decode_32k``, every axis for
``long_500k``): the flash-combine the reference's ``decode_attention``
leaves to XLA on a sequence-sharded cache, on the same two kernels.
Under tensor parallelism (:class:`TensorParallel`, the ``model`` axis)
each rank keeps its own query heads of the result.

:class:`TensorParallel`'s collectives are Megatron's autograd-aware ones
where autograd records their input (the train steps over a ``model``
axis): ``copy_to`` (*f*: identity forward, all-reduce backward),
``reduce`` (*g*: all-reduce forward, identity backward) and ``gather``
(all-gather forward; backward all-reduces the gradient and keeps this
rank's columns); ``max`` is a detached all-reduce max (the
vocab-parallel softmax's constant).  :meth:`TensorParallel.columns` is
*f* fused with the column-parallel products that read its input: on the
card their input gradients are written in float32 and summed over the
ranks before the one rounding.  :func:`row_partial` is a row-parallel
product's float32 partial, the term *g*'s sums add.
:class:`BatchSplit` names the batch axes' ranks (a MoE layer counts its
capacity over them).

``latent_partial`` / ``merge_latent`` / ``decode_latent_split`` are
MLA's weight-absorbed decode over a latent cache whose sequence is cut
over the ranks of a :class:`SequenceSplit`: each piece's float32
softmax partials for every head, gathered and merged.  Plain torch, as
the reference's latent decode is plain jnp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..kernels import flash_decode as fd

__all__ = ["NEG_INF", "TensorParallel", "SequenceSplit", "BatchSplit",
           "row_partial",
           "rms_norm", "rope", "swiglu", "swiglu_hidden", "chunked_attention",
           "decode_attention", "decode_attention_split", "latent_partial",
           "merge_latent", "decode_latent_split"]

NEG_INF = -1e30


def _tracked(x) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: the identity forward; backward, the sum of every
    rank's gradient (in float32, rounded once to the gradient's dtype)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.comm.all_reduce(grad.float()).to(grad.dtype), None


class _Reduce(torch.autograd.Function):
    """Megatron's *g*: the sum of every rank's ``x`` forward; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.comm.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` joined along the last dimension forward;
    backward, the sum of every rank's gradient of the whole (each rank may
    read any rank's columns), this rank's columns of it."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return torch.cat(tp.comm.all_gather(x), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        tp, n = ctx.tp, ctx.width
        whole = tp.comm.all_reduce(grad.float()).to(grad.dtype)
        return whole.narrow(-1, tp.index * n, n).contiguous(), None


class _RowPartial(torch.autograd.Function):
    """``h @ w`` written in float32 from operands in their own dtype
    (``torch.mm``'s ``out_dtype`` form, which has no derivative);
    backward, the two products in ``h``'s dtype, as autograd computes them
    for ``(h @ w).float()``: the gradient rounded to that dtype, then
    ``g @ w.T`` and ``h.T @ g`` over the rows folded to a matrix."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        return torch.mm(h2, w, out_dtype=torch.float32).reshape(
            *h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        g = grad.to(h.dtype).reshape(-1, w.shape[-1])
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = g.mm(w.t()).reshape(h.shape)
        if ctx.needs_input_grad[1]:
            gw = h.reshape(-1, h.shape[-1]).t().mm(g)
        return gh, gw


def _mm_f32(a, b):
    """``a @ b`` (matrices, or batches of them) written in float32 from
    operands in their own dtype: on the card ``torch.mm``'s or
    ``torch.bmm``'s ``out_dtype`` form (bf16 on the tensor cores), on the
    CPU (and for float32 operands) the float32 product."""
    if a.is_cuda and a.dtype != torch.float32:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Columns(torch.autograd.Function):
    """*f* and the column-parallel products ``x @ w`` of the ``ws`` that
    read ``x`` (the same on every rank): forward, the products in ``x``'s
    dtype; backward, each weight piece's gradient as autograd computes it
    and ``x``'s gradient as the products ``g @ w.T`` written in float32
    (:func:`_mm_f32`), added, summed over the ranks and rounded once to
    ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, tp, *ws):
        ctx.tp = tp
        ctx.save_for_backward(x, *ws)
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *grads):
        x, *ws = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        gx, gws = None, []
        for i, (w, g) in enumerate(zip(ws, grads)):
            g2 = g.reshape(-1, w.shape[-1])
            part = _mm_f32(g2, w.t())
            gx = part if gx is None else gx + part
            gws.append(x2.t().mm(g2) if ctx.needs_input_grad[2 + i]
                       else None)
        gx = ctx.tp.comm.all_reduce(gx).to(x.dtype).reshape(x.shape)
        return (gx, None, *gws)


def row_partial(h, w):
    """This rank's float32 partial ``h @ w`` of a row-parallel product
    (``w`` its rows): on the card the product takes ``h`` and ``w`` as
    they are (bf16 on the tensor cores) and writes float32, under autograd
    too (:class:`_RowPartial`); on the CPU it runs in float32."""
    if h.is_cuda:
        return _RowPartial.apply(h, w)
    return h.float() @ w.float()


@dataclass(frozen=True)
class TensorParallel:
    """Megatron tensor parallelism over one mesh axis: ``comm`` holds the
    axis group's collectives (``all_gather(x)`` -> every rank's ``x`` in
    rank order, ``all_reduce(x, op)`` -> their sum or max, each a new
    tensor on ``x``'s device), ``size`` the axis's ranks M and ``index``
    this rank's place on it.

    Where autograd records ``x`` (training), :meth:`copy_to`,
    :meth:`reduce` and :meth:`gather` are ``torch.autograd.Function``s
    whose backward runs the matching collective; elsewhere (serving under
    ``inference_mode``) they are the plain collectives.  Every rank issues
    them in the same order, the backward's and a checkpointed layer's
    recompute included, as the ranks build the same graph."""

    comm: Any
    size: int
    index: int

    def copy_to(self, x):
        """``x`` (the same on every rank) at the input of a
        column-parallel product or of a replicated weight read in a
        split region: itself, its gradient summed over the ranks."""
        return _CopyTo.apply(x, self) if _tracked(x) else x

    def columns(self, x, *ws):
        """``x @ w`` for each column-parallel piece ``w`` that reads
        ``x`` (the same on every rank); where autograd records ``x``,
        :class:`_Columns`: *f* whose backward sums the float32 partials of
        ``x``'s gradient before it rounds them."""
        if _tracked(x):
            return _Columns.apply(x, self, *ws)
        return tuple(x @ w for w in ws)

    def gather(self, x):
        """Every rank's ``x`` joined along the last dimension, in rank
        order."""
        if _tracked(x):
            return _Gather.apply(x, self)
        return torch.cat(self.comm.all_gather(x), dim=-1)

    def reduce(self, x):
        """The sum of every rank's ``x``."""
        return _Reduce.apply(x, self) if _tracked(x) else \
            self.comm.all_reduce(x)

    def max(self, x):
        """The largest of every rank's ``x``, element by element, outside
        autograd (a constant to it)."""
        return self.comm.all_reduce(x.detach(), op="max")


@dataclass(frozen=True)
class SequenceSplit:
    """A decode cache's sequence cut into ``size`` equal pieces over the
    ranks of one group: ``comm`` the group's collectives (as
    :class:`TensorParallel`'s), ``index`` the piece this rank holds,
    positions ``[index * T, (index + 1) * T)`` of a piece of T."""

    comm: Any
    size: int
    index: int


@dataclass(frozen=True)
class BatchSplit:
    """The mesh's batch axes (pod-major, then data) over the ranks of one
    group: ``comm`` its collectives (as :class:`TensorParallel`'s),
    ``size`` its ranks D, ``index`` this rank's place.  With ``rows`` the
    batch's rows are cut over them in that order, so a rank's tokens follow
    those of the ranks before it; without, every rank holds the whole
    batch (``long_500k``'s one row)."""

    comm: Any
    size: int
    index: int
    rows: bool = True


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding; x (..., S, H, d), positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_hidden(x, w_gate, w_up):
    """The gated hidden of :func:`swiglu`, before ``w_down``."""
    return torch.nn.functional.silu(x @ w_gate) * (x @ w_up)


def swiglu(x, w_gate, w_up, w_down):
    return swiglu_hidden(x, w_gate, w_up) @ w_down


def _live_rows(nchunks: int, chunk: int, S: int, causal: bool, q_offset: int,
               valid_len: int) -> list:
    """``(chunk index, first row)`` of each KV chunk that some query row
    attends to, with the rows before ``first row`` wholly masked in it.

    Every row attends to key 0 when ``valid_len >= 1`` and (causal) no
    row lies before it; its running max is then finite after chunk 0, and
    a chunk masked for it leaves its (m, l, acc) unchanged bit for bit
    (weights exp(-1e30 - m) = 0, alpha = 1).  Those chunks and rows are
    skipped.  Otherwise every chunk runs on every row, as the reference's
    scan does."""
    if valid_len < 1 or (causal and q_offset < 0):
        return [(ci, 0) for ci in range(nchunks)]
    out = []
    for ci in range(nchunks):
        base = ci * chunk
        r0 = max(0, base - q_offset) if causal else 0
        if base < valid_len and r0 < S:
            out.append((ci, r0))
    return out


def chunked_attention(q, k, v, *, chunk: int = 1024, causal: bool = True,
                      q_offset: int = 0, kv_len=None):
    """Flash-style streaming attention: an online softmax over KV chunks
    that never forms the (S, T) score matrix, one (S, chunk) block at a
    time.

    q (B, S, H, d); k (B, T, Hkv, d), v (B, T, Hkv, dv) with GQA groups
    G = H // Hkv (MLA: ``dv != d``); query row s sits at position
    ``q_offset + s``; keys at or past ``kv_len`` (default T) are masked.
    Scores, softmax and the value product run in float32 on the operands
    upcast (the reference's ``preferred_element_type=float32``); the
    result is in q's dtype.  Chunks and leading rows that a chunk masks
    wholly are skipped (:func:`_live_rows`).

    Without autograd (inference mode, no grad, or no operand that
    requires grad) the running (m, l, acc) and each chunk's scores are
    updated in place; with it, the same arithmetic runs out of place, so
    that autograd can differentiate it.  The two forward results are
    equal bit for bit."""
    B, S, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Hkv
    scale = 1.0 / (d ** 0.5)
    nchunks = -(-T // chunk)
    Tp = nchunks * chunk
    if Tp != T:  # padded keys are masked (kpos >= valid_len)
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Tp - T))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Tp - T))
    valid_len = T if kv_len is None else int(kv_len)
    dev = q.device
    # (B, Hkv, S, G, d): a run of rows s.. is one (rows * G, d) matrix
    qg = q.float().reshape(B, S, Hkv, G, d).permute(0, 2, 1, 3, 4).contiguous()
    m = torch.full((B, Hkv, S, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, S, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, S, G, dv), dtype=torch.float32, device=dev)
    q_pos = torch.arange(S, device=dev) + q_offset
    in_place = not (torch.is_grad_enabled()
                    and (q.requires_grad or k.requires_grad
                         or v.requires_grad))
    for ci, r0 in _live_rows(nchunks, chunk, S, causal, q_offset, valid_len):
        base = ci * chunk
        rows = S - r0
        kb = k[:, base:base + chunk].float().permute(0, 2, 3, 1)   # (B,Hkv,d,c)
        vb = v[:, base:base + chunk].float().transpose(1, 2)       # (B,Hkv,c,dv)
        s = torch.matmul(qg[:, :, r0:].reshape(B, Hkv, rows * G, d), kb)
        s = (s.mul_(scale) if in_place else s * scale).view(
            B, Hkv, rows, G, chunk)
        mask = None
        if base + chunk > valid_len or (causal and
                                        base + chunk - 1 > q_offset + r0):
            kpos = base + torch.arange(chunk, device=dev)
            mask = (kpos < valid_len)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= q_pos[r0:, None])
            mask = mask[:, None, :]
        if in_place:
            if mask is not None:
                s.masked_fill_(~mask, NEG_INF)
            m_old = m[:, :, r0:]
            m_new = torch.maximum(m_old, s.amax(-1))
            alpha = torch.exp(m_old - m_new)
            p = s.sub_(m_new[..., None]).exp_()
            l[:, :, r0:].mul_(alpha).add_(p.sum(-1))
            pv = torch.matmul(p.view(B, Hkv, rows * G, chunk), vb)
            acc[:, :, r0:].mul_(alpha[..., None]).add_(
                pv.view(B, Hkv, rows, G, dv))
            m_old.copy_(m_new)
            continue
        # the same arithmetic out of place, for autograd: rows before r0
        # keep their (m, l, acc), the rest are replaced
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, s.amax(-1))
        alpha = torch.exp(m_old - m_new)
        p = (s - m_new[..., None]).exp()
        l_new = l[:, :, r0:] * alpha + p.sum(-1)
        pv = torch.matmul(p.view(B, Hkv, rows * G, chunk), vb)
        acc_new = acc[:, :, r0:] * alpha[..., None] + pv.view(
            B, Hkv, rows, G, dv)
        m, l, acc = (torch.cat([old[:, :, :r0], new], dim=2) if r0 else new
                     for old, new in ((m, m_new), (l, l_new),
                                      (acc, acc_new)))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token attention over a KV cache: q (B, 1, H, d); caches
    (B, T, Hkv, d); the first ``cache_len`` positions valid."""
    B, _, H, d = q.shape
    return fd.decode_attention(q[:, 0], k_cache, v_cache,
                               cache_len).reshape(B, 1, H, d)


def decode_attention_split(q, k_piece, v_piece, cache_len,
                           seq: SequenceSplit,
                           tp: TensorParallel | None = None):
    """One-token attention over a cache whose sequence is cut over the
    ranks of ``seq``: q (B, 1, H, d) every query head; this rank's piece
    (B, T, Hkv, d) holds positions ``[seq.index * T, (seq.index + 1) *
    T)``; the first ``cache_len`` positions of the whole sequence valid (a
    device scalar, which the kernels read on the device).  Each rank's
    split runs on its piece at its offset, the pieces' float32 partials
    are gathered over ``seq``'s group, and each rank combines the
    ``seq.size`` pieces for every head.  Returns (B, 1, H, d), or with
    ``tp`` this rank's ``H / M`` heads ``[tp.index * H / M, ...)``."""
    B, _, H, d = q.shape
    T = k_piece.shape[1]
    ml, acc = fd.decode_piece(q[:, 0], k_piece, v_piece, cache_len,
                              seq.index * T)
    # one gather: (P, B, Hkv, ns, G, 2 + d), each piece's (m, l) then acc
    parts = torch.stack(seq.comm.all_gather(torch.cat([ml, acc], dim=-1)))
    ml, acc = parts[..., :2], parts[..., 2:]
    out = fd.combine_pieces(ml, acc, cache_len, T, q.dtype)
    if tp is not None:
        nh = H // tp.size
        out = out[:, tp.index * nh:(tp.index + 1) * nh]
    return out.reshape(B, 1, -1, d)


def latent_partial(q_abs, q_rope, ckv, kr, cache_len, offset, scale: float):
    """MLA's decode over one piece of a latent cache, every head: q_abs
    (B, 1, H, kv_lora) (``wk_b`` absorbed) and q_rope (B, 1, H, dh_rope);
    the piece ``ckv`` (B, T, kv_lora) and ``kr`` (B, T, dh_rope) holds
    positions ``[offset, offset + T)``, of which those below ``cache_len``
    are valid.  Returns the float32 softmax partials ``(ml, ctx)``: ``ml``
    (B, 1, H, 2) the scores' max and the sum of their exponentials below
    it, ``ctx`` (B, 1, H, kv_lora) the latent context weighted by them.  A
    piece with no valid position is neutral: max ``NEG_INF``, sum 0,
    context 0."""
    ckv32 = ckv.float()
    s = (torch.einsum("bshk,btk->bhst", q_abs.float(), ckv32)
         + torch.einsum("bshr,btr->bhst", q_rope.float(), kr.float())) * scale
    mask = offset + torch.arange(ckv.shape[1], device=ckv.device) < cache_len
    s = torch.where(mask, s, NEG_INF)
    top = s.amax(-1)                                            # (B, H, 1)
    p = torch.where(mask, torch.exp(s - top[..., None]), 0.0)
    ctx = torch.einsum("bhst,btk->bshk", p, ckv32)
    ml = torch.stack([top, p.sum(-1)], dim=-1).permute(0, 2, 1, 3)
    return ml, ctx


def merge_latent(ml, ctx):
    """The softmax over every piece from their stacked partials (``ml``
    (P, B, 1, H, 2), ``ctx`` (P, B, 1, H, kv_lora), as
    :func:`latent_partial` gives them): each piece weighted by the
    exponential of its max less the largest, so no exponential exceeds
    1.  Returns the latent context (B, 1, H, kv_lora) in float32."""
    top = ml[..., 0].amax(0)
    w = torch.exp(ml[..., 0] - top)                             # (P,B,1,H)
    total = (w * ml[..., 1]).sum(0)
    return (w[..., None] * ctx).sum(0) / total[..., None]


def decode_latent_split(q_abs, q_rope, ckv_piece, kr_piece, cache_len,
                        seq: SequenceSplit, scale: float):
    """MLA's one-token decode over a latent cache whose sequence is cut
    over the ranks of ``seq``: every head's q_abs and q_rope, this rank's
    pieces (B, T, ·) at offset ``seq.index * T``, the first ``cache_len``
    positions of the whole sequence valid.  Each rank's
    :func:`latent_partial`, gathered over ``seq``'s group in one
    all-gather and merged (:func:`merge_latent`): the latent context
    (B, 1, H, kv_lora) in float32, every head."""
    ml, ctx = latent_partial(q_abs, q_rope, ckv_piece, kr_piece, cache_len,
                             seq.index * ckv_piece.shape[1], scale)
    parts = torch.stack(seq.comm.all_gather(torch.cat([ml, ctx], dim=-1)))
    return merge_latent(parts[..., :2], parts[..., 2:])
