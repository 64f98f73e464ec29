"""AdamW with optional int8-quantized moments.

The port's copy of ``repro/optim/optimizer.py``: the same update, leaf
for leaf in the reference's flatten order (sorted dict keys), the bias
corrections ``1 - b**t`` in float32 as the reference computes them, and
the same blockwise-absmax int8 moment store (``_BLOCK`` = 128 elements a
block, the block count padded to a multiple of 64).  ``torch.round``
rounds half to even as ``jnp.round`` does, so the int8 moments and their
scales come out byte for byte the reference's on the same inputs.

The state is ``{"step": int32 scalar, "mu": tree}`` where ``mu`` mirrors
the parameter tree as nested dicts, each leaf ``{"m", "v"}`` (float32) or
``{"m_q", "m_s", "v_q", "v_s"}`` (int8 blocks and float32 scales).
:func:`adamw_update` writes the new parameters and moments into the
given tensors (the reference donates both) and returns them.

``compress_psum`` is the int8 all-reduce of data-parallel training over
the process group of the active mesh's axis
(:func:`repro_torch.launch.mesh.use_mesh`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["AdamWConfig", "Piece", "adamw_init", "adamw_update",
           "adamw_state_specs", "q8_encode", "q8_decode", "q8_state_specs",
           "compress_psum"]

F32 = torch.float32
_BLOCK = 128


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    quantize_moments: bool = False  # int8 m/v with per-block scales


class Piece(NamedTuple):
    """Where a parameter leaf is this rank's piece of a whole leaf (a
    weight split over a mesh's ``model`` axis): ``shape`` the whole's,
    ``cut(whole) -> piece`` and ``join(piece) -> whole`` (a collective:
    every rank of the axis calls it, in the same order)."""

    shape: tuple
    cut: Callable
    join: Callable


# ----------------------------------------------------- int8 moment codecs
def _q8_shapes(shape):
    n = 1
    for s in shape:
        n *= s
    blocks = -(-n // _BLOCK)
    blocks = -(-blocks // 64) * 64  # the reference shards blocks over 64
    return n, blocks


def q8_encode(x):
    """``(q, scale)``: int8 blocks ``(blocks, 128)`` and float32 scales
    ``(blocks,)`` of ``x``, zero-padded to whole blocks.  One float32
    temporary of ``x``'s size beside ``x`` (the quotient, rounded and
    clamped in place): a whole leaf of DeepSeek-V3's embedding is 3.7
    GB."""
    n, blocks = _q8_shapes(x.shape)
    flat = x.reshape(-1).to(F32)
    if blocks * _BLOCK != n:
        flat = torch.nn.functional.pad(flat, (0, blocks * _BLOCK - n))
    flat = flat.reshape(blocks, _BLOCK)
    scale = torch.linalg.vector_norm(flat, float("inf"), dim=1,
                                     keepdim=True) / 127.0 + 1e-12
    q = (flat / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale[:, 0].to(F32)


def q8_decode(q, scale, shape):
    n, _ = _q8_shapes(shape)
    flat = q.to(F32).mul_(scale[:, None])
    return flat.reshape(-1)[:n].reshape(shape)


def q8_state_specs(shape):
    """``(shape, dtype)`` of ``(q, scale)`` for a parameter of ``shape``."""
    _, blocks = _q8_shapes(shape)
    return ((blocks, _BLOCK), torch.int8), ((blocks,), F32)


# ------------------------------------------------------------------ AdamW
def adamw_init(params, cfg: AdamWConfig):
    """Zero moments beside each leaf of ``params``, on its device."""
    def one(p):
        if cfg.quantize_moments:
            q, s = q8_encode(torch.zeros(p.shape, dtype=F32, device=p.device))
            return {"m_q": q, "m_s": s, "v_q": q.clone(), "v_s": s.clone()}
        return {"m": torch.zeros(p.shape, dtype=F32, device=p.device),
                "v": torch.zeros(p.shape, dtype=F32, device=p.device)}

    device = next(t for _, t in tree_leaves(params)).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(one, params)}


def _leaf_state(mu, name: str) -> dict:
    for part in name.split("."):
        mu = mu[part]
    return mu


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 pieces: dict | None = None):
    """One AdamW step.  ``grads``: the gradients in ``tree_leaves(params)``
    order (a list), or a tree of the parameters' shape.  Writes the new
    parameters (cast back to each leaf's dtype) and moments in place and
    returns ``(params, state)``.

    ``pieces`` (leaf name -> :class:`Piece`) names the leaves that are a
    rank's piece of a whole parameter.  Float32 moments are pieces like
    their parameter; int8 moments cover the whole parameter, their blocks
    of 128 running over its flattened elements across the pieces' seams.
    So a piece's int8 moments are decoded whole and cut, updated on the
    piece, and joined whole again before they are encoded: the blocks and
    scales come out those of the one-device update of the whole."""
    leaves = tree_leaves(params)
    if not isinstance(grads, (list, tuple)):
        grads = [t for _, t in tree_leaves(grads)]
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} leaves")
    step = state["step"] + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    for (name, p), g in zip(leaves, grads):
        mu = _leaf_state(state["mu"], name)
        g = g.to(F32)
        piece = None if pieces is None else pieces.get(name)
        if cfg.quantize_moments:
            shape = p.shape if piece is None else piece.shape
            m = q8_decode(mu["m_q"], mu["m_s"], shape)
            v = q8_decode(mu["v_q"], mu["v_s"], shape)
            if piece is not None:
                m, v = piece.cut(m), piece.cut(v)
        else:
            m, v = mu["m"], mu["v"]
        # the reference's expressions op for op, each temporary freed or
        # reused as soon as it is spent (a leaf of DeepSeek-V3's embedding
        # is 3.7 GB in float32)
        m = (m * cfg.b1).add_(g * (1 - cfg.b1))
        gg = g * (1 - cfg.b2)
        v = (v * cfg.b2).add_(gg.mul_(g))
        del g, gg
        den = (v / bc2).sqrt_().add_(cfg.eps)
        upd = (m / bc1).div_(den)
        del den
        if cfg.quantize_moments:
            for key, x in (("m", m), ("v", v)):
                q, s = q8_encode(x if piece is None else piece.join(x))
                mu[key + "_q"].copy_(q)
                mu[key + "_s"].copy_(s)
                del q, s
        else:
            mu["m"].copy_(m)
            mu["v"].copy_(v)
        del m, v
        pf = p.to(F32)
        upd.add_(pf * cfg.weight_decay).mul_(cfg.lr)
        p.copy_(pf.sub_(upd))
        del upd, pf
    state["step"].copy_(step)
    return params, state


def adamw_state_specs(param_specs, cfg: AdamWConfig):
    """The ``(shape, dtype)`` tree of :func:`adamw_init`'s state for
    parameters given as a tree of ``(shape, dtype)`` pairs or ``Spec``s."""
    def one(p):
        shape = tuple(p.shape if hasattr(p, "shape") else p[0])
        if cfg.quantize_moments:
            q, s = q8_state_specs(shape)
            return {"m_q": q, "m_s": s, "v_q": q, "v_s": s}
        return {"m": (shape, F32), "v": (shape, F32)}

    return {"step": ((), torch.int32), "mu": tree_map(one, param_specs)}


# -------------------------------------------------- gradient compression
def compress_psum(grads, axis_name: str):
    """int8 all-reduce: quantize -> sum int32 -> dequantize (a quarter of
    the float32 bytes on the wire), the reference's ``compress_psum``.

    Over the process group of the active mesh's ``axis_name``
    (:func:`~repro_torch.launch.mesh.use_mesh`): each leaf's
    :func:`q8_encode` codes summed as int32 and its scales summed, then
    ``qsum * (ssum / n) / n`` over the group's size ``n``, cut back to the
    leaf's shape.  A tree in, a tree of float32 leaves out."""
    import torch.distributed as dist

    from ..launch.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("compress_psum runs inside `with use_mesh(mesh)`")
    # one rank and no process group: the sums are the rank's own
    group = None if mesh.device_mesh is None and mesh.axis_size(
        axis_name) == 1 else mesh.get_group(axis_name)
    n = 1 if group is None else dist.get_world_size(group)

    def one(g):
        q, s = q8_encode(g)
        qsum = q.to(torch.int32)
        ssum = s.clone()
        if group is not None:
            dist.all_reduce(qsum, group=group)
            dist.all_reduce(ssum, group=group)
        numel = g.numel()
        return (qsum.to(F32) * (ssum / n)[:, None] / n).reshape(-1)[
            :numel].reshape(g.shape)

    return tree_map(one, grads)
