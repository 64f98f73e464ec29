"""LM transformer, the dense GQA (+qk_norm) decode path.

The port's copy of the serving half of ``repro/models/transformer.py``:
the parameter specs of a dense GQA model (stacked per layer group, under
the reference's names and shapes), ``lm_forward`` with KV caches, logits,
the cache specs and one ``serve_decode`` step.  A Python loop over layers
takes the place of ``lax.scan``.  Caches keep the reference's layout
``(L, B, T, Hkv, dh)`` and are updated in place where the reference's
``dynamic_update_slice`` returns new arrays; ``len`` stays a device int32
scalar, so a decode step does not wait on the host.  The attention is
``layers.decode_attention``: the hand-written flash-decode kernels on CUDA
tensors, the reference's einsum form on CPU tensors.

Not ported yet (ROADMAP Queue 1 item 9): MLA, MoE and multi-token
prediction configs (they raise), and the cache-free forward (training and
prefill through ``chunked_attention``).
"""
from __future__ import annotations

import torch

from ..configs.base import LMConfig
from .layers import decode_attention, rms_norm, rope, swiglu
from .params import Spec, tree_init

__all__ = ["check_ported", "lm_param_specs", "lm_init", "layer_groups",
           "attention_block", "lm_forward", "lm_logits",
           "make_kv_cache_specs", "make_kv_caches", "serve_decode"]

F32 = torch.float32
_QUEUE = "ROADMAP Queue 1 item 9"


def check_ported(cfg: LMConfig) -> None:
    """Refuse what the port does not run yet: no silent dense stand-in."""
    for what, present in (("MLA attention", cfg.mla is not None),
                          ("MoE layers", cfg.moe is not None),
                          ("multi-token prediction", cfg.mtp_depth > 0)):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet ({_QUEUE})")


# ---------------------------------------------------------------- param specs
def _attn_specs(cfg: LMConfig, L: int) -> dict:
    E, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cfg.dtype
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


def _layer_group_specs(cfg: LMConfig, L: int) -> dict:
    E = cfg.d_model
    return {
        "attn": _attn_specs(cfg, L),
        "ln_attn": Spec((L, E), F32, (None, "embed"), init="ones"),
        "ln_mlp": Spec((L, E), F32, (None, "embed"), init="ones"),
        "mlp": _dense_mlp_specs(cfg, L),
    }


def layer_groups(cfg: LMConfig) -> list[tuple[str, int]]:
    """[(group name, depth)]: one dense group."""
    check_ported(cfg)
    return [("layers", cfg.n_layers)]


def lm_param_specs(cfg: LMConfig) -> dict:
    E, dt = cfg.d_model, cfg.dtype
    specs = {
        "embed": Spec((cfg.vocab, E), dt, ("vocab", "embed"), scale=1.0),
        "ln_f": Spec((E,), F32, ("embed",), init="ones"),
        "lm_head": Spec((E, cfg.vocab), dt, ("embed", "vocab")),
    }
    for name, depth in layer_groups(cfg):
        specs[name] = _layer_group_specs(cfg, depth)
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
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, cfg: LMConfig, x, positions, cache):
    """Writes this step's k, v into the layer's caches in place and
    returns the attention output.  ``cache`` is ``(k_cache, v_cache,
    len)`` with caches (B, T, Hkv, dh) and ``len`` a device int32 scalar."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    k_cache, v_cache, length = cache
    # in place of dynamic_update_slice: positions len .. len+S-1
    pos = (length + torch.arange(S, device=x.device)).long()
    k_cache.index_copy_(1, pos, k.to(k_cache.dtype))
    v_cache.index_copy_(1, pos, v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, length + S)
    return out.reshape(B, S, -1) @ p["wo"]


# ------------------------------------------------------------------- layers
def _dense_mlp(p, x):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _layer_slice(gp, i: int) -> dict:
    """Layer ``i``'s parameters of a stacked group (views)."""
    return {k: _layer_slice(v, i) if not isinstance(v, torch.Tensor) else v[i]
            for k, v in ((k, gp[k]) for k in gp.keys())}


def _layer(cfg: LMConfig, x, lp, positions, cache):
    a = attention_block(lp["attn"], cfg, rms_norm(x, lp["ln_attn"]), positions,
                        cache)
    x = x + a
    h = rms_norm(x, lp["ln_mlp"])
    return x + _dense_mlp(lp["mlp"], h)


def lm_forward(params, cfg: LMConfig, tokens, positions=None, caches=None):
    """tokens (B, S) -> (hidden (B, S, E), caches).  Needs ``caches`` (the
    decode path); their k, v are written in place and ``len`` advanced."""
    if caches is None:
        raise NotImplementedError(
            f"the cache-free forward (chunked_attention: training and prefill)"
            f" is not ported yet ({_QUEUE})")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    length = caches["len"]
    offset = 0
    for name, depth in layer_groups(cfg):
        gp = params[name]
        for i in range(depth):
            cache = (caches["k"][offset + i], caches["v"][offset + i], length)
            x = _layer(cfg, x, _layer_slice(gp, i), positions, cache)
        offset += depth
    caches["len"] = length + S
    return rms_norm(x, params["ln_f"]), caches


def lm_logits(params, cfg: LMConfig, hidden):
    return hidden @ params["lm_head"]


def make_kv_cache_specs(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """Decode-cache ``(shape, dtype)`` of each entry."""
    check_ported(cfg)
    kv = ((cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim), cfg.dtype)
    return {"k": kv, "v": kv, "len": ((), torch.int32)}


def make_kv_caches(cfg: LMConfig, batch: int, max_len: int, device) -> dict:
    """Zeroed caches on ``device``."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in
            make_kv_cache_specs(cfg, batch, max_len).items()}


def serve_decode(params, cfg: LMConfig, tokens, caches):
    """One decode step: tokens (B, 1) + caches -> (logits, caches), the
    caches updated in place."""
    B = tokens.shape[0]
    positions = caches["len"].reshape(1, 1).expand(B, 1)
    hidden, caches = lm_forward(params, cfg, tokens, positions, caches)
    return lm_logits(params, cfg, hidden), caches
