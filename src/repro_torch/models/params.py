"""Parameter spec trees and the module that holds them.

The port's copy of ``repro/models/params.py``: a model's parameters are
declared once as a nested dict of :class:`Spec` leaves (shape, torch
dtype, logical axes, init), and :func:`tree_init` materializes them as a
:class:`ParamTree`, an ``nn.Module`` whose nesting and leaf names are the
reference's, so ``params["mlp"]["w1"]`` reads the same in both packages.
Its leaves do not require grad (serving); a train step turns
``requires_grad`` on for them (:func:`requires_grad`) and takes them in
the reference's flatten order, sorted dict keys (:func:`tree_leaves`).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Any

import torch
from torch import nn

__all__ = ["Spec", "ParamTree", "tree_init", "tree_num_params",
           "tree_leaves", "tree_map", "requires_grad", "tree_shardings"]


@dataclass(frozen=True)
class Spec:
    shape: tuple
    dtype: Any = torch.float32
    axes: tuple = ()          # logical axis names (len == ndim; None = unsharded)
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


class ParamTree(nn.Module):
    """Nested parameters under the reference's names: a leaf is an
    ``nn.Parameter`` (no gradient until a train step asks for one,
    :func:`requires_grad`), a branch another ``ParamTree``.
    ``tree[name]`` reads a child."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def keys(self) -> list:
        return sorted([*self._parameters, *self._modules])


def _branch(x) -> bool:
    return isinstance(x, (dict, ParamTree))


def tree_map(fn, tree) -> dict:
    """``fn`` over every leaf of a nested dict or :class:`ParamTree`, as
    nested dicts under the same names."""
    return {k: tree_map(fn, tree[k]) if _branch(tree[k]) else fn(tree[k])
            for k in sorted(tree.keys())}


def requires_grad(tree) -> list:
    """Turn ``requires_grad`` on for every leaf of ``tree``; returns the
    leaves in :func:`tree_leaves` order."""
    leaves = [t for _, t in tree_leaves(tree)]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def tree_leaves(tree, prefix: str = "") -> list:
    """``(dotted name, leaf)`` of every leaf of a nested dict or
    :class:`ParamTree` (of specs, tensors or arrays), in the
    reference's flatten order: sorted keys."""
    out = []
    for name in sorted(tree.keys()):
        value = tree[name]
        if _branch(value):
            out += tree_leaves(value, f"{prefix}{name}.")
        else:
            out.append((f"{prefix}{name}", value))
    return out


#: elements of a normal leaf drawn at once: a larger leaf is drawn slice by
#: slice along its leading axes, so the float32 draw stays ~256 MB beside
#: the leaf (DeepSeek-V3's stacked expert leaf is 15 GB in bfloat16)
DRAW_ELEMENTS = 1 << 26


def _draw(out: torch.Tensor, s: Spec, generator: torch.Generator) -> None:
    n = out.numel()
    if n <= DRAW_ELEMENTS or out.dim() == 1:
        x = torch.randn(out.shape, generator=generator, dtype=torch.float32,
                        device=out.device)
        out.copy_(x.mul_(s.scale))
    elif out.shape[0] == 1:
        _draw(out[0], s, generator)
    else:
        step = max(1, DRAW_ELEMENTS // (n // out.shape[0]))
        for i in range(0, out.shape[0], step):
            _draw(out[i:i + step], s, generator)


def _init_leaf(s: Spec, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=dev)
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    _draw(out, s, generator)
    return out


def tree_init(spec_tree, generator: torch.Generator, cut=None) -> ParamTree:
    """Materialize the parameters on ``generator.device``: normal leaves
    are ``N(0, 1) * scale`` drawn in float32 and cast to the leaf's dtype,
    leaf after leaf in sorted key order from ``generator`` (a leaf past
    :data:`DRAW_ELEMENTS` slice after slice along its leading axes).
    ``cut(name, leaf)``, given, replaces each leaf as soon as it is drawn
    (by a rank's piece of it: the whole leaf is then freed before the next
    is drawn); ``name`` is its dotted name in :func:`tree_leaves`."""
    def build(tree, prefix):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = build(v, f"{prefix}{k}.")
            else:
                leaf = _init_leaf(v, generator)
                out[k] = leaf if cut is None else cut(f"{prefix}{k}", leaf)
                del leaf
        return out

    with torch.no_grad():
        return ParamTree(build(spec_tree, ""))


def tree_num_params(spec_tree) -> int:
    return int(sum(prod(s.shape) for _, s in tree_leaves(spec_tree)))


def tree_shardings(spec_tree, mesh, rules: dict):
    """Logical axis names -> mesh axes: a
    :class:`~repro_torch.launch.mesh.Sharding` for each :class:`Spec` leaf,
    its dimension named ``a`` split over ``rules.get(a)``; unknown and
    None axes stay whole (the reference's ``tree_shardings``)."""
    from ..launch.mesh import Sharding

    def one(s: Spec):
        axes = s.axes if s.axes else (None,) * len(s.shape)
        return Sharding(mesh, [rules.get(a) if a is not None else None
                               for a in axes])

    return tree_map(one, spec_tree)
