"""Shared neural layers of the decode path: RMSNorm, RoPE, SwiGLU and the
one-token decode attention.

The port's copy of ``repro/models/layers.py`` (``rms_norm``, ``rope``,
``swiglu``, ``decode_attention``).  ``decode_attention`` on CUDA tensors
runs the hand-written flash-decode kernels (``kernels/flash_decode.py``),
the single-chip form the reference names for it; on CPU tensors it runs
the reference's einsum form.  ``chunked_attention`` (training and prefill)
is not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels import flash_decode as fd

__all__ = ["rms_norm", "rope", "swiglu", "decode_attention"]


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


def swiglu(x, w_gate, w_up, w_down):
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token attention over a KV cache: q (B, 1, H, d); caches
    (B, T, Hkv, d); the first ``cache_len`` positions valid."""
    B, _, H, d = q.shape
    return fd.decode_attention(q[:, 0], k_cache, v_cache,
                               cache_len).reshape(B, 1, H, d)
