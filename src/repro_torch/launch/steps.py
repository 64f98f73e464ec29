"""Cell assembly: (arch x shape x mesh) -> a step function, the ``(shape,
dtype)`` of its arguments and where each lives on the mesh.

The port's copy of ``repro/launch/steps.py``.  Each ``_build_*`` returns a
:class:`StepBundle` whose ``fn`` runs eagerly on the tensors it is given
(on their device), and, on a mesh, the reference's placements of every
argument and output (``in_shardings`` / ``out_shardings``:
:class:`~repro_torch.launch.mesh.Sharding` trees) by its rules:

* LM train      — batch over the batch axes (pod, data); Megatron TP over
                  ``model`` (heads / mlp / vocab / expert); experts' embed
                  dim over the batch axes; optimizer state mirrors the
                  params with its embed dim over the batch axes (ZeRO-1;
                  int8-moment blocks over them);
* LM prefill    — batch over the batch axes, heads over ``model``;
* LM decode_32k — cache batch over the batch axes, cache sequence over
                  ``model``;
* LM long_500k  — batch 1: cache sequence over every axis;
* GNN           — edges over every axis; node state and params replicated;
* RecSys        — embedding rows over ``model``; batch over the batch axes;
* CoreGraph     — the shard backend: shards over every axis, core
                  replicated.

The train steps are the reference's: ``value_and_grad`` of ``lm_loss`` /
``gnn_loss`` / ``mind_train_loss`` (``torch.autograd.grad`` over the
parameters' leaves in the reference's flatten order, :func:`value_and_grad`)
then ``adamw_update``, which writes the new parameters and moments into
the given tensors (the reference donates both).  The LM step accumulates
gradients over microbatches of at most ``REPRO_TORCH_ACCUM_TOKENS`` tokens
a data shard (8,192 by default; the reference's ``REPRO_ACCUM_TOKENS``),
each microbatch divisible by the data shards (:func:`accum_steps`):
microbatch ``i`` is the global batch's rows ``[i * B / accum, (i + 1) * B
/ accum)``, cut over the batch axes, as the reference's.  The serve steps
run under ``torch.inference_mode()``.

**Execution.**  With no mesh, or a mesh of one rank, ``fn`` is the
one-device step.  On a mesh whose process group spans it
(``make_host_mesh`` in a group, or a ``Mesh`` of any ``(data, model)``
shape over a ``DeviceMesh`` of the group), ``fn`` takes this rank's piece
of every argument (:func:`local_args` cuts them from the global ones by
``in_shardings``) and returns this rank's piece of every output
(:func:`gather_outputs` joins them).  Collectives run over the axes'
groups (``Mesh.get_group``); a gloo group takes CUDA tensors through the
host.  On any mesh:

* LM and MIND train steps take each rank's batch slice, average the loss
  and the gradients over the batch axes' group before ``adamw_update``
  (:func:`_train_ranks`); only the parameters split over the batch axes
  (the experts' embed pieces) are joined over them, for the forward.
  AdamW then runs on each rank's ZeRO-1 share of every leaf, the moments
  never joined (:func:`_shares`): float32 moments by their piece (the
  embed slice over the batch axes), int8 moments by the rank's range of
  blocks of the whole leaf's flattened elements, decoded and encoded
  alone; each parameter replicated over the batch axes is rebuilt from
  the ranks' updated elements by one all-gather over them.  The GNN train
  step updates its int8 moments by block range the same way.  With more
  than one microbatch an LM rank's microbatch ``i`` is its slice of the
  reference's microbatch ``i`` (the int32 tokens and labels gathered over
  the batch axes, then cut), so a MoE layer's drops come from the same
  tokens.  With a ``model`` axis of M > 1 every weight split over
  ``model`` stays this rank's piece, never gathered whole: the LMs' loss
  runs Megatron tensor parallelism with its autograd-aware collectives
  and the vocab-parallel cross entropy (``models.transformer.lm_loss(
  tp=)``: MoE experts, MLA's heads and MTP included), MIND's rows its own
  (``models.recsys.mind_train_loss(tp=)``, kernel #4 on a rank's row
  piece under autograd); the float32 moments are the param's pieces, and
  for the int8 moments, whose blocks run over the whole parameter and are
  replicated over ``model``, each model rank updates the elements of its
  block range in its piece and the model group all-gathers the range's
  new m and v (1/D of the leaf) before every model rank encodes them.
* A MoE layer on a batch cut over the batch axes counts the reference's
  global capacity (``models.moe``, a ``layers.BatchSplit``: the
  per-expert counts all-gathered over the batch axes, each rank's
  positions offset by the ranks before it); ``long_500k``'s one row is
  whole on every rank and keeps its own count.

With a ``model`` axis of 1:

* the GNN train step splits the edges over every rank and keeps node
  state whole (``models.gnn.edges_split``);
* serve steps take the batch over the batch axes; ``retrieval_step`` takes
  its users whole on every rank and the candidates over the batch axes,
  and merges the ranks' top k;
* the core-graph cell is one SemiCore* superstep of the shard backend
  over the group (``core.resident.build_shard_chunk_fn``, ``chunk=1``).

With a ``model`` axis of M > 1, the LMs' ``prefill_32k`` and
``decode_32k`` run Megatron tensor parallelism on the weight pieces
(``models.transformer``, a ``layers.TensorParallel`` over the ``model``
group; no weight split over ``model`` is gathered whole), the batch over
the batch axes at the same time: prefill attends each rank's ``H / M``
query heads; decode holds positions ``[r * T / M, (r + 1) * T / M)`` of the
cache on model rank r, writes the token's k and v on the rank that holds
``len`` and merges the ranks' flash-decode partials (kernel #5 on each
piece, its combine across the ranks).  The MoE configs
hold experts ``[r * X / M, (r + 1) * X / M)`` on model rank r and route
every token on every rank (``models.moe``, one all-reduce a layer); over
D > 1 data ranks too, where a rank joins its experts' embed pieces over
the batch axes a group of experts at a time; MLA
(DeepSeek-V3) cuts ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` by heads and,
decoding, merges every head's float32 partials over the ranks' latent
cache pieces (``layers.decode_latent_split``).  The logits come out cut
by vocab.  ``long_500k`` (batch 1, whole on every rank) cuts its cache
sequence over every axis, data-major (a ``layers.SequenceSplit`` over the
group of all axes, beside the tensor parallelism over ``model`` where M >
1): the token's k and v (MLA: its latent and rope key) are written on the
one rank of all D * M that holds ``len``, and each rank combines the D *
M pieces' partials.  MIND's serve and retrieval steps hold ``item_embed``
and ``profile_embed`` as row pieces over ``model`` and the MLP
Megatron-split (``models.recsys``, ``tp``); the GNN train step splits its
edges over every axis whatever the mesh's shape.

Still raising ``NotImplementedError`` when run: M not dividing
``n_heads`` or the experts (the reference's ``NamedSharding`` refuses
it).  A mesh with no process group and more than one rank (a production
mesh) describes placements only.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from math import prod
from typing import Any, Callable

import torch

from ..configs import get_config
from ..configs.base import CoreGraphConfig, GNNConfig, LMConfig, RecsysConfig
from ..configs.shapes import input_specs
from ..models import gnn as gnn_m
from ..models import recsys as rec_m
from ..models import transformer as tfm
from ..models.layers import BatchSplit, SequenceSplit, TensorParallel
from ..models.params import (requires_grad, tree_init, tree_leaves,
                             tree_map, tree_num_params, tree_shardings)
from ..optim import AdamWConfig, Share, adamw_state_specs, adamw_update
from ..optim.optimizer import q8_state_specs
from .mesh import Mesh, Sharding

__all__ = ["StepBundle", "build_step", "default_opt", "value_and_grad",
           "accum_steps", "local_args", "local_init", "gather_outputs"]

F32 = torch.float32
_TP = "ROADMAP Queue 1 item 8"
_TOP_K = 100  # mind_retrieval's top_k


@dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple                 # (shape, dtype) trees, positional
    in_shardings: Any = None    # Sharding trees like args (None: no mesh)
    out_shardings: Any = None
    donate_argnums: tuple = ()
    num_params: int = 0
    static: dict | None = None


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


def accum_steps(B: int, S: int, data_shards: int = 1) -> int:
    """The reference's microbatch count for a (B, S) batch over
    ``data_shards``: the largest divisor ``k`` of ``B`` at most
    ``ceil(B * S / data_shards / budget)`` whose microbatch ``B / k``
    stays divisible by the data shards, the budget being
    ``REPRO_TORCH_ACCUM_TOKENS`` tokens (8,192)."""
    budget = int(os.environ.get("REPRO_TORCH_ACCUM_TOKENS", 8192))
    tokens_per_chip = B * S // max(data_shards, 1)
    want = max(1, -(-tokens_per_chip // budget))
    for cand in range(min(want, B), 0, -1):
        if B % cand == 0 and (B // cand) % data_shards == 0:
            return cand
    return 1


# ================================================================= meshes
def _batch_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def _all_axes(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def _ns(mesh, *spec) -> Sharding:
    return Sharding(mesh, spec)


def _ba_rule(mesh: Mesh):
    ba = _batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def _lm_rules(mesh: Mesh) -> dict:
    """TP over model; experts 2D (expert x embed over the batch axes);
    weights otherwise replicated over the batch axes."""
    return {"heads": "model", "kv_heads": "model", "mlp": "model",
            "vocab": "model", "expert": "model", "rows": "model",
            "embed": None, "expert_embed": _ba_rule(mesh)}


def _zero1_rules(rules: dict, mesh: Mesh) -> dict:
    """Optimizer-state rules: the embed dim also over the batch axes
    (ZeRO-1)."""
    return {**rules, "embed": _ba_rule(mesh)}


def _opt_shardings(param_specs, mesh, rules, opt: AdamWConfig):
    param_sh = tree_shardings(param_specs, mesh, rules)
    if not opt.quantize_moments:
        mu = tree_map(lambda s: {"m": s, "v": s}, param_sh)
    else:
        ba = _batch_axes(mesh)
        q, s = _ns(mesh, ba, None), _ns(mesh, ba)
        mu = tree_map(lambda _: {"m_q": q, "m_s": s, "v_q": q, "v_s": s},
                      param_sh)
    return {"step": _ns(mesh), "mu": mu}


def _is_tree(x) -> bool:
    return hasattr(x, "keys") and not isinstance(x, torch.Tensor)


def _zip_map(fn, tree, sh):
    """``fn(leaf, sharding)`` over a tree and its sharding tree (a single
    Sharding applies to every leaf under it)."""
    if _is_tree(tree):
        return {k: _zip_map(fn, tree[k], sh if isinstance(sh, Sharding)
                            else sh[k]) for k in sorted(tree.keys())}
    return fn(tree, sh)


def _split_dims(shape, sh: Sharding, over) -> list:
    """``(dim, axes, ranks)`` of each dimension of an array of ``shape``
    that ``sh`` splits over more than one rank (with ``over``, a tuple of
    axis names, only those split over some of them alone)."""
    out = []
    for d in range(len(shape)):
        axes = sh.dim_axes(d)
        k = sh.mesh.axis_size(axes)
        if k > 1 and (over is None or set(axes) <= set(over)):
            out.append((d, axes, k))
    return out


def _cut_dims(shape, sh: Sharding, over) -> list:
    """:func:`_split_dims` of a whole array of ``shape``, refusing a
    dimension that its ranks do not divide, as the reference's
    ``NamedSharding`` refuses it."""
    dims = _split_dims(shape, sh, over)
    for d, axes, k in dims:
        if shape[d] % k:
            raise ValueError(
                f"dimension {d} of a {tuple(shape)} tensor does not "
                f"divide over the {k} ranks of {axes}")
    return dims


def _narrow(x, sh: Sharding, over=None):
    """This rank's piece of ``x`` placed by ``sh``, a view (with ``over``,
    cut only along the dimensions split over those axes)."""
    for d, axes, k in _cut_dims(x.shape, sh, over):
        size = x.shape[d] // k
        x = x.narrow(d, sh.mesh.axis_index(axes) * size, size)
    return x


def _piece(x, sh: Sharding, over=None):
    """This rank's piece of a whole tensor ``x`` placed by ``sh`` (with
    ``over``, cut only along the dimensions split over those axes), a
    copy where it is cut."""
    if not isinstance(x, torch.Tensor):
        return x
    y = _narrow(x, sh, over)
    return x if y is x else y.clone()


def _comm(mesh: Mesh, axes):
    """The collectives over the group of ``axes`` (the shard backend's: a
    gloo group takes CUDA tensors through the host)."""
    from ..core.engine import _Collectives

    return _Collectives(mesh.get_group(axes))


def _whole(x, sh: Sharding, over=None):
    """The whole tensor from every rank's piece ``x`` placed by ``sh``
    (one all-gather a split dimension; with ``over``, only along the
    dimensions split over those axes)."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, axes, _ in _split_dims(x.shape, sh, over):
        x = torch.cat(_comm(sh.mesh, axes).all_gather(x), d)
    return x


def local_args(bundle: StepBundle, *args) -> tuple:
    """This rank's piece of each global argument of ``bundle.fn``, cut by
    ``bundle.in_shardings`` (the arguments themselves without a mesh)."""
    if bundle.in_shardings is None:
        return args
    return tuple(_zip_map(_piece, a, sh)
                 for a, sh in zip(args, bundle.in_shardings))


def local_init(spec_tree, shardings, generator: torch.Generator):
    """This rank's pieces of the parameters ``tree_init(spec_tree,
    generator)`` would draw whole, cut by ``shardings`` (a bundle's
    ``in_shardings[0]``): each leaf drawn in the same order from
    ``generator`` and cut at once, so the rank holds its pieces and at most
    one whole leaf, never the whole model.  Equal to ``local_args`` of the
    whole tree."""
    sh_of = dict(tree_leaves(shardings))
    return tree_init(spec_tree, generator,
                     cut=lambda name, leaf: _piece(leaf, sh_of[name]))


def gather_outputs(bundle: StepBundle, out):
    """The global outputs of ``bundle.fn`` from this rank's pieces, joined
    by ``bundle.out_shardings`` (every rank gets them whole)."""
    if bundle.out_shardings is None:
        return out
    sh = bundle.out_shardings
    if isinstance(out, tuple):
        return tuple(_zip_map(_whole, o, s) for o, s in zip(out, sh))
    return _zip_map(_whole, out, sh)


def _ranks(mesh) -> bool:
    """Whether ``mesh`` runs over more than one rank (and may: a process
    group spans it)."""
    if mesh is None or mesh.size == 1:
        return False
    if mesh.device_mesh is None:
        raise RuntimeError(
            f"{mesh} has no process group: its steps describe placements "
            "(the dry run); run them on make_host_mesh() inside a group")
    return True


def _on_mesh(mesh, one_device: Callable, ranks: Callable) -> Callable:
    """``one_device`` without a mesh or on one rank, ``ranks`` over the
    ranks of ``mesh`` (decided when the step runs)."""
    if mesh is None or mesh.size == 1:
        return one_device

    def step(*args):
        return ranks(*args) if _ranks(mesh) else one_device(*args)

    return step


def _mean_over(mesh, axes, tensors) -> None:
    """Average ``tensors`` in place over the group of ``axes`` (nothing to
    do over one rank)."""
    k = mesh.axis_size(axes)
    if k == 1:
        return
    comm = _comm(mesh, axes)
    for t in tensors:
        t.copy_(comm.all_reduce(t)).div_(k)


def _tp_of(cfg: LMConfig, mesh) -> TensorParallel | None:
    """Tensor parallelism over ``mesh``'s model axis for an LM step (None
    for an axis of 1); raises where the port has none: an axis that does
    not divide the query heads or the experts."""
    M = mesh.shape.get("model", 1)
    if M == 1:
        return None
    if cfg.n_heads % M:
        raise NotImplementedError(
            f"a model axis of {M} does not divide {cfg.name}'s "
            f"{cfg.n_heads} query heads ({_TP})")
    if cfg.moe is not None and cfg.moe.num_experts % M:
        raise NotImplementedError(
            f"a model axis of {M} does not divide {cfg.name}'s "
            f"{cfg.moe.num_experts} experts ({_TP})")
    return _model_tp(mesh)


def _batch_split(mesh, rows: bool = True) -> BatchSplit | None:
    """The batch axes' ranks of ``mesh`` (None for one), pod-major; with
    ``rows`` the batch's rows are cut over them."""
    ba = _batch_axes(mesh)
    D = mesh.axis_size(ba)
    if D == 1:
        return None
    return BatchSplit(_comm(mesh, ba), D, mesh.axis_index(ba), rows)


def _model_tp(mesh) -> TensorParallel | None:
    """Tensor parallelism over ``mesh``'s model axis (None for an axis of
    1)."""
    M = mesh.shape.get("model", 1)
    if M == 1:
        return None
    return TensorParallel(_comm(mesh, "model"), M, mesh.axis_index("model"))


def _padded(x, size: int):
    """``x`` (1-D) zero-padded to ``size`` elements, for an all-gather of
    lists of unequal lengths."""
    return x if x.numel() == size else torch.cat(
        [x, x.new_zeros(size - x.numel())])


class _PieceShare(Share):
    """A leaf's update on this rank's piece of its float32 moments
    (``o_sh`` over the batch axes: under ``_zero1_rules`` the embed
    slice, beside the experts' ``expert_embed`` pieces; a leaf with
    neither is updated whole on every rank).  The parameter is rebuilt
    from the ranks' updated slices by one all-gather over the batch axes,
    unless it is itself split there, as the moments are: then the rank
    keeps its updated piece."""

    def __init__(self, ba, p_sh: Sharding, o_sh: Sharding, shape):
        self.ba, self.o_sh = ba, o_sh
        self.cut = bool(_cut_dims(shape, o_sh, ba))
        self.kept = bool(_cut_dims(shape, p_sh, ba))

    def take(self, x):
        return _narrow(x, self.o_sh, self.ba)

    def put(self, x, leaf):
        if self.kept:
            return x
        return leaf.copy_(_whole(x, self.o_sh, self.ba) if self.cut else x)


def _box(shape, sh: Sharding, r: int, M: int) -> list:
    """``(start, size)`` of each dimension of model rank ``r``'s piece of a
    leaf of ``shape`` placed by ``sh`` over a model axis of ``M``."""
    return [(r * (n // M), n // M) if "model" in sh.dim_axes(d) else (0, n)
            for d, n in enumerate(shape)]


def _before(i: int, shape, box) -> int:
    """How many elements of ``box`` lie before flat index ``i`` of a
    row-major ``shape`` (a piece's elements, taken in the whole's order,
    are in the piece's own row-major order: this is where flat index
    ``i`` falls in it)."""
    inner = prod(size for _, size in box)
    if i >= prod(shape):
        return inner
    count, stride = 0, prod(shape)
    for n, (start, size) in zip(shape, box):
        inner //= size
        stride //= n
        c = i // stride % n
        count += min(max(c - start, 0), size) * inner
        if not start <= c < start + size:
            break
    return count


def _positions(a: int, b: int, shape, box, device):
    """The whole leaf's flat indices of elements ``[a, b)`` of ``box``, in
    its row-major order."""
    i = torch.arange(a, b, dtype=torch.int64, device=device)
    pos, stride = torch.zeros_like(i), 1
    for n, (start, size) in zip(reversed(shape), reversed(box)):
        pos += (i % size + start) * stride
        i = i.div_(size, rounding_mode="floor")
        stride *= n
    return pos


class _BlockShare(Share):
    """A leaf's update on this rank's int8 blocks: blocks ``[d * nb / D,
    (d + 1) * nb / D)`` of the whole leaf's flattened elements for batch
    rank ``d`` of ``D``, replicated over ``model``.  With the leaf split
    over a model axis of ``M > 1`` each model rank updates the elements
    of that range in its piece, and the model group all-gathers the new
    float32 m and v of the range (1/D of the leaf) so that every model
    rank encodes the same blocks.  The parameter is rebuilt by one
    all-gather over the batch axes of the ranks' updated elements (a
    piece's elements over the ranges, in order, are the piece's own);
    a parameter split over the batch axes is cut again from it."""

    def __init__(self, mesh, ba, p_sh: Sharding, shape):
        self.mesh, self.ba, self.p_sh, self.shape = mesh, ba, p_sh, shape
        D, d = mesh.axis_size(ba), mesh.axis_index(ba)
        (blocks, width), _ = q8_state_specs(shape)[0]
        if blocks % D:
            raise ValueError(
                f"the {blocks} int8 blocks of a {tuple(shape)} leaf do not "
                f"divide over the {D} ranks of {ba}")
        n, per = prod(shape), blocks // D * width
        split = any("model" in p_sh.dim_axes(i) for i in range(len(shape)))
        M = mesh.shape.get("model", 1) if split else 1
        self.r = mesh.axis_index("model") if M > 1 else 0
        self.boxes = [_box(shape, p_sh, r, M) for r in range(M)]
        # cuts[e][r]: model rank r's elements [a, b) in batch rank e's range
        self.cuts = [[(_before(e * per, shape, box),
                       _before((e + 1) * per, shape, box))
                      for box in self.boxes] for e in range(D)]
        self.lo, self.d = d * per, d
        self.span = max(0, min(n, self.lo + per) - self.lo)
        self.a, self.b = self.cuts[d][self.r]
        self.kept = bool(_cut_dims(shape, p_sh, ba))

    def take(self, x):
        return x.reshape(-1)[self.a:self.b]

    def _at(self, r: int, device):
        """Where model rank ``r``'s elements lie in this range's list."""
        a, b = self.cuts[self.d][r]
        return _positions(a, b, self.shape, self.boxes[r], device) - self.lo

    def mine(self, x):
        return x if len(self.boxes) == 1 else x[self._at(self.r, x.device)]

    def join(self, x):
        if len(self.boxes) == 1:
            return x
        counts = [b - a for a, b in self.cuts[self.d]]
        lists = _comm(self.mesh, "model").all_gather(_padded(x, max(counts)))
        out = x.new_empty(self.span)
        for r, (got, c) in enumerate(zip(lists, counts)):
            out[self._at(r, x.device)] = got[:c]
        return out

    def put(self, x, leaf):
        counts = [cut[self.r][1] - cut[self.r][0] for cut in self.cuts]
        if len(counts) > 1:
            lists = _comm(self.mesh, self.ba).all_gather(
                _padded(x, max(counts)))
            x = torch.cat([got[:c] for got, c in zip(lists, counts)])
        whole = x.view(leaf.shape)
        if self.kept:
            return _piece(whole, self.p_sh, self.ba)
        return leaf.copy_(whole)


def _shares(mesh, pspecs, p_shard, o_shard, opt: AdamWConfig) -> dict:
    """Leaf name -> this rank's share of its AdamW update over the batch
    axes of ``mesh`` (``optim.Share``): the piece of its float32 moments,
    or its range of int8 blocks, as ``o_shard`` places them.  Raises where
    the batch axes' ranks divide neither (the reference's
    ``NamedSharding`` refuses it)."""
    ba = _batch_axes(mesh)
    p_of, o_of = dict(tree_leaves(p_shard)), dict(tree_leaves(o_shard["mu"]))
    out = {}
    for name, spec in tree_leaves(pspecs):
        shape = tuple(spec.shape)
        out[name] = _BlockShare(mesh, ba, p_of[name], shape) \
            if opt.quantize_moments else \
            _PieceShare(ba, p_of[name], o_of[name + ".m"], shape)
    return out


def _train_ranks(mesh, pspecs, p_shard, o_shard, opt: AdamWConfig,
                 grads_of: Callable) -> Callable:
    """The train step over the ranks of ``mesh`` (ZeRO-1 as the reference
    places it): the parameters split over the batch axes (the experts'
    embed pieces) joined for the forward, every other leaf this rank's
    ``model`` piece as it is; ``grads_of(params, *batch) -> (loss,
    grads)`` on this rank's batch slice, the loss and gradients averaged
    over the batch axes; then AdamW on this rank's share of each leaf
    (:func:`_shares`), the moments never joined."""
    ba = _batch_axes(mesh)

    def ranks(params, opt_state, *batch):
        shares = _shares(mesh, pspecs, p_shard, o_shard, opt)
        params = _zip_map(lambda x, s: _whole(x, s, ba), params, p_shard)
        loss, grads = grads_of(params, *batch)
        _mean_over(mesh, ba, [loss, *grads])
        params, opt_state = adamw_update(params, grads, opt_state, opt,
                                         shares)
        return params, opt_state, loss

    return ranks


# ===================================================================== LM
def _build_lm(cfg: LMConfig, shape_name, step_kind, avals, mesh, opt,
              reduced):
    pspecs = tfm.lm_param_specs(cfg)
    p_avals = _avals(pspecs)
    n_params = tree_num_params(pspecs)
    if mesh is not None:
        ba = _batch_axes(mesh)
        rules = _lm_rules(mesh)
        p_shard = tree_shardings(pspecs, mesh, rules)

    if step_kind == "train":
        o_avals = adamw_state_specs(pspecs, opt)
        B, S = avals["tokens"][0]
        shards = 1 if mesh is None else mesh.axis_size(ba)
        accum = accum_steps(B, S, shards)

        def grads_of(params, tokens, labels, tp=None, dp=None):
            """(loss, grads) over the microbatches: ``tokens`` and
            ``labels`` stacked (accum, b, S), or this rank's (B, S) of
            one microbatch."""
            if accum == 1:
                return value_and_grad(tfm.lm_loss, params, cfg, tokens,
                                      labels, tp, dp)
            grads, loss = None, torch.zeros((), dtype=F32,
                                            device=tokens.device)
            for t, lab in zip(tokens, labels):
                mb_loss, g = value_and_grad(tfm.lm_loss, params, cfg, t, lab,
                                            tp, dp)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=F32, device=x.device)
                             for x in g]
                for acc, x in zip(grads, g):
                    acc.add_(x)
                del g
                loss = loss + mb_loss
            for acc in grads:
                acc.div_(accum)
            return loss / accum, grads

        def microbatches(tokens, labels):
            return (tokens, labels) if accum == 1 else (
                tokens.reshape(accum, -1, S), labels.reshape(accum, -1, S))

        def step(params, opt_state, tokens, labels):
            loss, grads = grads_of(params, *microbatches(tokens, labels))
            params, opt_state = adamw_update(params, grads, opt_state, opt)
            return params, opt_state, loss

        bundle = StepBundle(
            name="train_step", fn=step,
            args=(p_avals, o_avals, avals["tokens"], avals["labels"]),
            donate_argnums=(0, 1), num_params=n_params,
            static={"opt": opt, "cfg": cfg, "accum": accum,
                    "pspecs": pspecs})
        if mesh is None:
            return bundle
        o_shard = _opt_shardings(pspecs, mesh, _zero1_rules(rules, mesh), opt)
        tok_sh = _ns(mesh, ba, None)

        def ranks(params, opt_state, tokens, labels):
            tp = _tp_of(cfg, mesh)  # raises before any collective
            dp = _batch_split(mesh)
            if accum > 1 and dp is not None:
                # microbatch i: this rank's slice of the global batch's
                # rows [i * B / accum, (i + 1) * B / accum)
                tokens, labels = (
                    torch.cat(dp.comm.all_gather(x)).reshape(
                        accum, dp.size, -1, S)[:, dp.index]
                    for x in (tokens, labels))
            else:
                tokens, labels = microbatches(tokens, labels)
            return _train_ranks(
                mesh, pspecs, p_shard, o_shard, opt,
                lambda p, t, lab: grads_of(p, t, lab, tp, dp))(
                    params, opt_state, tokens, labels)

        bundle.static["rules"] = rules
        return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                       in_shardings=(p_shard, o_shard, tok_sh, tok_sh),
                       out_shardings=(p_shard, o_shard, _ns(mesh)))

    if step_kind == "prefill":
        def step(params, tokens):
            with torch.inference_mode():
                return tfm.serve_prefill(params, cfg, tokens)

        bundle = StepBundle(name="serve_prefill", fn=step,
                            args=(p_avals, avals["tokens"]),
                            num_params=n_params)
        if mesh is None:
            return bundle

        def ranks(params, tokens):
            tp = _tp_of(cfg, mesh)
            if tp is None:
                params = _zip_map(_whole, params, p_shard)
            with torch.inference_mode():
                return tfm.serve_prefill(params, cfg, tokens, tp,
                                         _batch_split(mesh))

        return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                       in_shardings=(p_shard, _ns(mesh, ba, None)),
                       out_shardings=_ns(mesh, ba, None, "model"))

    def step(params, tokens, caches):
        with torch.inference_mode():
            return tfm.serve_decode(params, cfg, tokens, caches)

    bundle = StepBundle(name="serve_decode", fn=step,
                        args=(p_avals, avals["tokens"], avals["caches"]),
                        donate_argnums=(2,), num_params=n_params)
    if mesh is None:
        return bundle
    long_ctx = shape_name == "long_500k"
    if long_ctx:
        cache_b, cache_t = None, _all_axes(mesh)
    else:
        cache_b, cache_t = ba, "model"

    def cache_sharding(key):
        if key == "len":
            return _ns(mesh)
        # (L, B, T, ...): rank 4 (MLA: ckv/kr) or 5 (k/v)
        rank = 5 if cfg.mla is None else 4
        return _ns(mesh, None, cache_b, cache_t, *(None,) * (rank - 3))

    c_shard = {k: cache_sharding(k) for k in avals["caches"]}

    def ranks(params, tokens, caches):
        tp = _tp_of(cfg, mesh)
        seq = None
        if long_ctx:  # the sequence over every rank, data-major
            seq = SequenceSplit(_comm(mesh, cache_t), mesh.axis_size(cache_t),
                                mesh.axis_index(cache_t))
        if tp is None:
            params = _zip_map(_whole, params, p_shard)
        # long_500k's one row is whole on every rank: its MoE capacity is
        # its own, the batch axes only join the experts' embed pieces
        dp = _batch_split(mesh, rows=not long_ctx)
        with torch.inference_mode():
            return tfm.serve_decode(params, cfg, tokens, caches, tp, seq, dp)

    return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                   in_shardings=(p_shard, _ns(mesh, cache_b, None), c_shard),
                   out_shardings=(_ns(mesh, cache_b, None, "model"),
                                  dict(c_shard)))


# ===================================================================== GNN
def _build_gnn(cfg: GNNConfig, shape_name, step_kind, avals, mesh, opt,
               reduced):
    batch_avals = avals["batch"]
    N = avals["num_nodes"]
    d_in = batch_avals["x"][0][-1] if "x" in batch_avals else 0
    pspecs = gnn_m.gnn_param_specs(cfg, d_in)
    p_avals = _avals(pspecs)
    o_avals = adamw_state_specs(pspecs, opt)

    def loss_fn(params, batch):
        return gnn_m.gnn_loss(params, cfg, {**batch, "num_nodes": N})

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, loss

    bundle = StepBundle(name="train_step", fn=step,
                        args=(p_avals, o_avals, batch_avals),
                        donate_argnums=(0, 1),
                        num_params=tree_num_params(pspecs),
                        static={"opt": opt, "cfg": cfg, "pspecs": pspecs,
                                "num_nodes": N})
    if mesh is None:
        return bundle
    p_shard = tree_shardings(pspecs, mesh, {})  # replicated (small models)
    o_shard = _opt_shardings(pspecs, mesh, {}, opt)
    edge_sh, repl = _ns(mesh, _all_axes(mesh)), _ns(mesh)
    b_shard = {k: edge_sh if k in ("src", "dst") else repl
               for k in batch_avals}

    def ranks(params, opt_state, batch):
        shares = _shares(mesh, pspecs, p_shard, o_shard, opt)
        with gnn_m.edges_split(mesh.get_group(_all_axes(mesh))):
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt,
                                         shares)
        return params, opt_state, loss

    return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                   in_shardings=(p_shard, o_shard, b_shard),
                   out_shardings=(p_shard, o_shard, repl))


# ================================================================== recsys
def _build_recsys(cfg: RecsysConfig, shape_name, step_kind, avals, mesh, opt,
                  reduced):
    pspecs = rec_m.mind_param_specs(cfg)
    p_avals = _avals(pspecs)
    n_params = tree_num_params(pspecs)
    if mesh is not None:
        ba = _batch_axes(mesh)
        rules = {"rows": "model", "embed": None, "mlp": "model",
                 "embed2": None}
        p_shard = tree_shardings(pspecs, mesh, rules)

        def batch_shard(k, aval):
            shape = aval[0]
            if k == "candidate_ids":
                return _ns(mesh, ba)
            if shape[0] == 1:  # retrieval: a single user, replicated
                return _ns(mesh)
            return _ns(mesh, ba, *([None] * (len(shape) - 1)))

        b_shard = {k: batch_shard(k, v) for k, v in avals.items()}

    if step_kind == "train":
        o_avals = adamw_state_specs(pspecs, opt)

        def step(params, opt_state, batch):
            loss, grads = value_and_grad(rec_m.mind_train_loss, params, cfg,
                                         batch)
            params, opt_state = adamw_update(params, grads, opt_state, opt)
            return params, opt_state, loss

        bundle = StepBundle(name="train_step", fn=step,
                            args=(p_avals, o_avals, avals),
                            donate_argnums=(0, 1), num_params=n_params,
                            static={"opt": opt, "cfg": cfg,
                                    "pspecs": pspecs})
        if mesh is None:
            return bundle
        o_shard = _opt_shardings(pspecs, mesh, rules, opt)

        def grads_of(params, batch):
            return value_and_grad(rec_m.mind_train_loss, params, cfg, batch,
                                  _model_tp(mesh))

        return replace(bundle, fn=_on_mesh(
            mesh, step, _train_ranks(mesh, pspecs, p_shard, o_shard, opt,
                                     grads_of)),
                       in_shardings=(p_shard, o_shard, b_shard),
                       out_shardings=(p_shard, o_shard, _ns(mesh)))

    if step_kind == "serve":
        def step(params, batch):
            with torch.inference_mode():
                return rec_m.mind_serve(params, cfg, batch)

        bundle = StepBundle(name="serve_step", fn=step, args=(p_avals, avals),
                            num_params=n_params)
        if mesh is None:
            return bundle

        def ranks(params, batch):
            with torch.inference_mode():
                return rec_m.mind_serve(params, cfg, batch, _model_tp(mesh))

        return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                       in_shardings=(p_shard, b_shard),
                       out_shardings=_ns(mesh, ba, None, None))

    def step(params, batch):
        with torch.inference_mode():
            return rec_m.mind_retrieval(params, cfg, batch)

    bundle = StepBundle(name="retrieval_step", fn=step, args=(p_avals, avals),
                        num_params=n_params)
    if mesh is None:
        return bundle

    def ranks(params, batch):
        # each rank scores its slice of the candidates for every user (a
        # batch cut over the batch axes is gathered whole first); the top
        # k of the ranks' top k, positions offset by each slice's start
        batch = {k: v if k == "candidate_ids" else _whole(v, b_shard[k])
                 for k, v in batch.items()}
        with torch.inference_mode():
            vals, idx = rec_m.mind_retrieval(params, cfg, batch, _TOP_K,
                                             _model_tp(mesh))
        comm = _comm(mesh, ba)
        idx = idx + mesh.axis_index(ba) * batch["candidate_ids"].shape[0]
        v = torch.cat(comm.all_gather(vals), -1)
        i = torch.cat(comm.all_gather(idx), -1)
        top = torch.topk(v, min(_TOP_K, v.shape[-1]), dim=-1)
        return top.values, torch.gather(i, -1, top.indices)

    return replace(bundle, fn=_on_mesh(mesh, step, ranks),
                   in_shardings=(p_shard, b_shard),
                   out_shardings=(_ns(mesh), _ns(mesh)))


# =============================================================== coregraph
def _build_coregraph(cfg: CoreGraphConfig, shape_name, step_kind, avals,
                     mesh, opt, reduced):
    """One SemiCore* superstep of the shard backend (``chunk=1``) over the
    mesh: ``fn(ss, core, cnt, active, nact)`` of
    ``core.resident.build_shard_chunk_fn`` (``fn.backend`` binds a graph
    into ``ss``).  ``args`` are the reference's stacked shard arrays, for
    sizing; their placements are the reference's (None: the chunk
    function places its own)."""
    from ..core.resident import build_shard_chunk_fn

    specs = avals["specs"]
    fn = build_shard_chunk_fn(mesh, "semicore*", cfg.n, avals["num_probes"],
                              chunk=1)
    args = (specs["core0"], specs["cnt"], specs["active"], specs["nactive"],
            specs["dst"], specs["rows"], specs["edge_mask"],
            specs["lsegptr"], specs["owned_ids"], specs["owned_mask"])
    return StepBundle(name="decompose", fn=fn, args=args, num_params=0)


def default_opt(cfg, quantize_moments: bool | None = None,
                **kw) -> AdamWConfig:
    """The reference's AdamW for ``cfg``: int8 moments for LMs of
    ``d_model >= 7000`` unless ``quantize_moments`` says otherwise; ``kw``
    sets the other fields."""
    if quantize_moments is None:
        quantize_moments = cfg.kind == "lm" and cfg.d_model >= 7000
    return AdamWConfig(quantize_moments=quantize_moments, **kw)


def build_step(arch_id: str, shape_name: str, mesh: Mesh | None = None, *,
               reduced: bool = False, opt: AdamWConfig | None = None,
               quantize_moments: bool | None = None,
               depth_override: int | None = None) -> StepBundle:
    """The step of one cell, as the reference's ``build_step`` assembles
    it, on ``mesh`` (None: one device, no placements; the core-graph cell
    then takes a one-shard layout).  AdamW moments are int8 for LMs of
    ``d_model >= 7000`` unless ``quantize_moments`` or ``opt`` says
    otherwise."""
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    if depth_override is not None and cfg.kind == "lm":
        cfg = replace(cfg, n_layers=depth_override)
    if opt is None:
        opt = default_opt(cfg, quantize_moments)
    if cfg.kind == "coregraph" and mesh is None:
        mesh = Mesh((1, 1), ("data", "model"))
    num_shards = 1 if mesh is None else mesh.size
    step_kind, avals = input_specs(cfg, shape_name, num_shards=num_shards,
                                   reduced=reduced)
    build: dict[str, Any] = {"lm": _build_lm, "gnn": _build_gnn,
                             "recsys": _build_recsys,
                             "coregraph": _build_coregraph}
    return build[cfg.kind](cfg, shape_name, step_kind, avals, mesh, opt,
                           reduced)

