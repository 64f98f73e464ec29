"""Carry graphs, decomposition state and model parameters into the port
from plain fields.

Objects of another implementation (the JAX package's ``CSRGraph``,
``BufferedGraph`` and ``DecompResult`` among them) are read only through
their numpy fields, by attribute, never by importing that implementation:

* :func:`csr_from` — any object with ``indptr``/``adj`` arrays;
* :func:`buffered_from` — any object with a ``base`` CSR and the buffered
  edge deltas (``_ins``/``_del`` endpoint sets, ``_deg_delta``, ``version``,
  ``flushes``, ``capacity``);
* :func:`warm_state` — a ``(core, cnt)`` pair, or any object with ``core``
  and ``cnt`` arrays;
* :func:`update_batch_from` — any iterable of ops with ``kind`` ("+" or
  "-") and ``u``/``v`` fields (the JAX package's ``UpdateBatch``);
* :func:`maintainer_state_from` — any object with a buffered graph ``bg``
  and ``core``/``cnt`` arrays (the JAX package's ``CoreMaintainer``);
* :func:`params_from` (:func:`mind_params_from`, :func:`lm_params_from`)
  — a parameter tree as nested dicts of numpy arrays, leaf for leaf;
* :func:`opt_state_from` — the reference's AdamW state (plain or int8
  moments) as nested dicts of numpy arrays, beside the port's parameters.

Each returns the port's own objects (or int64 numpy arrays), so both
implementations compute on the same inputs.
"""
from __future__ import annotations

import numpy as np

from .graph.storage import CSRGraph
from .graph.updates import BufferedGraph

__all__ = ["csr_from", "buffered_from", "warm_state",
           "update_batch_from", "maintainer_state_from", "params_from",
           "mind_params_from", "lm_params_from", "opt_state_from"]


def csr_from(graph) -> CSRGraph:
    """The port's CSRGraph over copies of ``graph.indptr`` / ``graph.adj``."""
    return CSRGraph(indptr=np.array(graph.indptr, dtype=np.int64),
                    adj=np.array(graph.adj, dtype=np.int32))


def buffered_from(buffered) -> BufferedGraph:
    """The port's BufferedGraph holding the same base CSR and the same
    buffered edge deltas (and structural version and flush count) as
    ``buffered``."""
    out = BufferedGraph(csr_from(buffered.base),
                        buffer_capacity=buffered.capacity)
    out._ins = {int(u): {int(v) for v in vs} for u, vs in buffered._ins.items()}
    out._del = {int(u): {int(v) for v in vs} for u, vs in buffered._del.items()}
    out._size = int(buffered._size)
    out._deg_delta = np.array(buffered._deg_delta, dtype=np.int64)
    out.version = int(buffered.version)
    out.flushes = int(buffered.flushes)
    return out


def warm_state(core, cnt=None) -> tuple:
    """``(core, cnt)`` as int64 numpy copies; ``core`` may instead be an
    object with ``core``/``cnt`` arrays (a decomposition result)."""
    if cnt is None and hasattr(core, "core"):
        core, cnt = core.core, core.cnt
    return (np.array(core, dtype=np.int64),
            None if cnt is None else np.array(cnt, dtype=np.int64))


def update_batch_from(batch):
    """The port's :class:`~repro_torch.core.update.UpdateBatch` of the same
    ops, in the same order, read by each op's ``kind``, ``u`` and ``v``."""
    from .core.update import Delete, Insert, UpdateBatch

    kinds = {"+": Insert, "-": Delete}
    return UpdateBatch(kinds[op.kind](int(op.u), int(op.v)) for op in batch)


def maintainer_state_from(maintainer) -> tuple:
    """``(BufferedGraph, core, cnt)`` of a maintainer mid-stream: its
    buffered graph through :func:`buffered_from` and its state through
    :func:`warm_state`, ready for ``CoreMaintainer(bg, state=(core,
    cnt))``."""
    core, cnt = warm_state(maintainer.core, maintainer.cnt)
    return buffered_from(maintainer.bg), core, cnt


def params_from(arrays, spec_tree, device=None):
    """The port's :class:`~repro_torch.models.params.ParamTree` holding
    ``arrays``, a parameter tree of the JAX package given as nested dicts
    of numpy arrays (``jax.tree.map(np.asarray, params)``), leaf for leaf
    under the reference's names.  Each leaf must have its spec's shape and
    is stored in its spec's dtype; a missing or extra leaf raises.

    ``device`` ``None`` means the first GPU and raises without one
    (:func:`repro_torch.core.engine.resolve_device`): only an explicit
    ``device="cpu"`` lands the weights on the host."""
    import torch

    from .core.engine import resolve_device
    from .models.params import ParamTree

    device = resolve_device(device)

    def carry(arr_tree, specs, path):
        if not isinstance(arr_tree, dict):
            raise ValueError(f"{path or 'params'}: expected a dict of leaves")
        missing = sorted(set(specs) - set(arr_tree))
        extra = sorted(set(arr_tree) - set(specs))
        if missing or extra:
            raise ValueError(f"{path or 'params'}: missing leaves {missing}, "
                             f"extra leaves {extra}")
        out = {}
        for name, spec in specs.items():
            where = f"{path}.{name}" if path else name
            if isinstance(spec, dict):
                out[name] = carry(arr_tree[name], spec, where)
                continue
            a = np.asarray(arr_tree[name])
            if tuple(a.shape) != tuple(spec.shape):
                raise ValueError(f"{where}: shape {a.shape} != "
                                 f"{tuple(spec.shape)}")
            if a.dtype.kind not in "fiub":  # bfloat16 and other extensions
                a = a.astype(np.float32)
            out[name] = torch.tensor(a).to(
                device=device, dtype=spec.dtype)
        return out

    with torch.no_grad():
        return ParamTree(carry(arrays, spec_tree, ""))


def mind_params_from(arrays, cfg, device=None):
    """MIND's parameters (:func:`repro_torch.models.recsys.mind_param_specs`)
    from the reference's tree."""
    from .models.recsys import mind_param_specs

    return params_from(arrays, mind_param_specs(cfg), device)


def lm_params_from(arrays, cfg, device=None):
    """The LM's parameters
    (:func:`repro_torch.models.transformer.lm_param_specs`: dense, MoE and
    MLA layer groups and the multi-token-prediction tree) from the
    reference's tree."""
    from .models.transformer import lm_param_specs

    return params_from(arrays, lm_param_specs(cfg), device)


def opt_state_from(arrays, params, device=None):
    """The port's AdamW state (:func:`repro_torch.optim.adamw_init`'s
    layout) holding ``arrays``, the reference's ``{"step", "mu"}`` as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, state)``),
    beside ``params`` (the port's parameter tree): each leaf's moments
    ``{"m", "v"}`` in float32 or ``{"m_q", "m_s", "v_q", "v_s"}`` (int8
    blocks, float32 scales) of the shapes its parameter takes.  A missing
    or extra leaf, or a wrong shape, raises.  ``device`` as in
    :func:`params_from`."""
    import torch

    from .core.engine import resolve_device
    from .models.params import tree_leaves
    from .optim.optimizer import q8_state_specs

    device = resolve_device(device)
    plain, q8 = {"m", "v"}, {"m_q", "m_s", "v_q", "v_s"}
    leaves = dict(tree_leaves(params))
    got = dict(tree_leaves(arrays["mu"]))
    names = {n.rsplit(".", 1)[0] for n in got}
    if names != set(leaves):
        raise ValueError(f"mu: missing leaves {sorted(set(leaves) - names)}, "
                         f"extra leaves {sorted(names - set(leaves))}")
    mu: dict = {}
    for name, p in leaves.items():
        keys = {n.rsplit(".", 1)[1] for n in got if n.rsplit(".", 1)[0] == name}
        if keys == plain:
            want = {"m": (tuple(p.shape), torch.float32),
                    "v": (tuple(p.shape), torch.float32)}
        elif keys == q8:
            (qs, qd), (ss, sd) = q8_state_specs(tuple(p.shape))
            want = {"m_q": (qs, qd), "m_s": (ss, sd), "v_q": (qs, qd),
                    "v_s": (ss, sd)}
        else:
            raise ValueError(f"mu.{name}: moments {sorted(keys)}, expected "
                             f"{sorted(plain)} or {sorted(q8)}")
        node = mu
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        out = node[name.split(".")[-1]] = {}
        for key, (shape, dtype) in want.items():
            a = np.asarray(got[f"{name}.{key}"])
            if tuple(a.shape) != shape:
                raise ValueError(f"mu.{name}.{key}: shape {a.shape} != "
                                 f"{shape}")
            out[key] = torch.tensor(a).to(device=device, dtype=dtype)
    return {"step": torch.tensor(int(np.asarray(arrays["step"])),
                                 dtype=torch.int32, device=device),
            "mu": mu}
