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
given tensors (the reference donates both) and returns them.  Over a
mesh a rank updates only its share of each leaf, the part whose moments
it holds (:class:`Share`; ``launch.steps`` makes them): AdamW is
elementwise and the int8 blocks are independent of each other, so the
share's numbers are the whole update's, bit for bit.

``compress_psum`` is the int8 all-reduce of data-parallel training over
the process group of the active mesh's axis
(:func:`repro_torch.launch.mesh.use_mesh`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["AdamWConfig", "Share", "adamw_init", "adamw_update",
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


class Share:
    """The part of one leaf's update that a rank makes: the elements whose
    moments it holds.  This one is the whole leaf (one device); a mesh's
    shares (``launch.steps``) narrow it to a rank's ZeRO-1 piece.

    * ``take(x)``: the share's elements of ``x``, the parameter as the
      step's forward held it or its gradient: a tensor of the float32
      moments' shape, or with int8 moments a flat list, the leaf's
      elements in the rank's block range that lie in its ``model`` piece;
    * ``span``: int8 moments: the leaf's elements in the rank's blocks
      (the rest of them padding);
    * ``mine(x)``: the rank's own elements of a list over the span;
      ``join(x)``: the span's list from every ``model`` rank's own (a
      collective: every rank of the axis calls it, in the same order);
    * ``put(x, leaf)``: the parameter the rank keeps, from its updated
      elements ``x`` (in the leaf's dtype) and the forward's ``leaf``
      (written in place where the rank keeps that tensor)."""

    def __init__(self, leaf, quantized: bool):
        self.quantized = quantized
        self.span = leaf.numel()

    def take(self, x):
        return x.reshape(-1) if self.quantized else x

    def mine(self, x):
        return x

    def join(self, x):
        return x

    def put(self, x, leaf):
        return leaf.copy_(x.view(leaf.shape))


# ----------------------------------------------------- int8 moment codecs
def _q8_shapes(shape):
    n = 1
    for s in shape:
        n *= s
    blocks = -(-n // _BLOCK)
    blocks = -(-blocks // 64) * 64  # the reference shards blocks over 64
    return n, blocks


def q8_encode(x, blocks: int | None = None):
    """``(q, scale)``: int8 blocks ``(blocks, 128)`` and float32 scales
    ``(blocks,)`` of ``x``, zero-padded to whole blocks (``blocks``: a
    rank's count of a leaf's blocks, ``x`` the elements they hold; by
    default a whole leaf's, a multiple of 64).  One float32 temporary of
    ``x``'s size beside ``x`` (the quotient, rounded and clamped in
    place)."""
    n, whole = _q8_shapes(x.shape)
    blocks = whole if blocks is None else blocks
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


def _update_leaf(p, g, mu: dict, cfg: AdamWConfig, bc1, bc2,
                 share: Share):
    """One leaf's AdamW on ``share``: its moments ``mu`` written in place,
    the parameter ``share.put`` returns.  The reference's expressions op
    for op, each temporary freed or reused as soon as it is spent (a
    whole leaf of DeepSeek-V3's embedding is 3.7 GB in float32)."""
    q8 = cfg.quantize_moments

    def moment(key):
        return share.mine(q8_decode(mu[key + "_q"], mu[key + "_s"],
                                    (share.span,))) if q8 else mu[key]

    g = share.take(g).to(F32)
    m = (moment("m") * cfg.b1).add_(g * (1 - cfg.b1))
    gg = g * (1 - cfg.b2)
    v = (moment("v") * cfg.b2).add_(gg.mul_(g))
    del g, gg
    den = (v / bc2).sqrt_().add_(cfg.eps)
    upd = (m / bc1).div_(den)
    del den
    for key, x in (("m", m), ("v", v)):
        if q8:
            q, s = q8_encode(share.join(x), mu[key + "_q"].shape[0])
            mu[key + "_q"].copy_(q)
            mu[key + "_s"].copy_(s)
            del q, s
        else:
            mu[key].copy_(x)
    del m, v, x
    pf = share.take(p).to(F32, copy=True)
    upd.add_(pf * cfg.weight_decay).mul_(cfg.lr)
    pf.sub_(upd)
    del upd
    return share.put(pf.to(p.dtype), p)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 shares: dict | None = None):
    """One AdamW step.  ``grads``: the gradients in ``tree_leaves(params)``
    order (a list), or a tree of the parameters' shape.  Writes the new
    moments in place and returns ``(params, state)``.

    ``shares`` (leaf name -> :class:`Share`) names the leaves of which a
    rank updates a part, the elements whose moments it holds over a
    mesh's batch axes (ZeRO-1); every other leaf is its own whole share.
    A share's moments are decoded, updated and encoded on the share alone,
    never joined whole.  The new parameters are written into ``params``'
    leaves, except where a share keeps a piece of a leaf that the step's
    forward held joined: the returned tree then holds that piece in its
    place (nested dicts)."""
    leaves = tree_leaves(params)
    if not isinstance(grads, (list, tuple)):
        grads = [t for _, t in tree_leaves(grads)]
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} leaves")
    step = state["step"] + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    out, same = {}, True
    for (name, p), g in zip(leaves, grads):
        share = (shares or {}).get(name) or Share(p, cfg.quantize_moments)
        out[name] = _update_leaf(p, g, _leaf_state(state["mu"], name), cfg,
                                 bc1, bc2, share)
        same = same and out[name] is p
    state["step"].copy_(step)
    return (params if same else _nest(out)), state


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, x in flat.items():
        *path, leaf = name.split(".")
        d = tree
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = x
    return tree


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
