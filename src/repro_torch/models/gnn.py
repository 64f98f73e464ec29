"""GNN zoo: GraphSAGE, GCN, SchNet, EGNN on a segment-sum substrate.

The port's copy of ``repro/models/gnn.py``.  Every mode is an edge list
``(src, dst)`` over a node set of ``n`` rows; messages gather from ``src``
and sum into ``dst`` (:func:`_segsum`, ``index_add`` into zeros: the
reference's ``jax.ops.segment_sum``).  Full-graph aggregation is the same
superstep as the decomposition engine's: a gather over the edge axis and
a sum into the node rows.  The sampled cells are flattened two-hop
subgraphs and the molecule cells disjoint unions, fed the same way.

``params`` is the :class:`~repro_torch.models.params.ParamTree` of
:func:`gnn_param_specs` (or nested dicts of tensors under the same names).
SchNet and EGNN take positions and atomic numbers as inputs.

Edges split over the ranks of a process group (:func:`edges_split`, the
mesh step of ``launch/steps.py``): each rank holds a slice of ``(src,
dst)`` and the whole node state.  Each sum over edges then adds the
ranks' partial sums (an all-reduce forward, identity backward:
:class:`_EdgeSum`), and each replicated tensor entering rank-local edge
work (node rows gathered by an edge end, a parameter of a per-edge MLP)
passes :class:`_Fanout` (identity forward, all-reduce backward), so every
rank's gradient of a replicated tensor is the whole one, once.  With no
split both are the one-device functions.

One divergence from the reference: an id past ``n`` (or negative) in
``src``, ``dst`` or ``graph_ids`` raises on the CPU and trips a device
assert on the card, where ``segment_sum`` drops it and ``take`` fills it.
No source makes one: padded edges point at the sink row ``n - 1``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..configs.base import GNNConfig
from .params import Spec

__all__ = ["gnn_param_specs", "gnn_loss", "graphsage_forward", "gcn_forward",
           "schnet_forward", "egnn_forward", "graphsage_param_specs",
           "gcn_param_specs", "schnet_param_specs", "egnn_param_specs",
           "edges_split"]

F32 = torch.float32


# ------------------------------------------------------------------ helpers
def _mlp_specs(d_in, d_hidden, d_out, name_dims=("embed", "mlp", "embed")):
    return {
        "w1": Spec((d_in, d_hidden), F32, (name_dims[0], name_dims[1])),
        "b1": Spec((d_hidden,), F32, (name_dims[1],), init="zeros"),
        "w2": Spec((d_hidden, d_out), F32, (name_dims[1], name_dims[2])),
        "b2": Spec((d_out,), F32, (name_dims[2],), init="zeros"),
    }


def _mlp(p, x, act=F.silu):
    return act(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class _SegmentSum(torch.autograd.Function):
    """``index_add`` of ``vals`` rows into ``n`` zero rows by ``idx``; its
    backward gathers the gradient's rows by ``idx`` (``segment_sum``'s
    transpose).  Only ``idx`` is saved: torch's own ``index_add`` keeps
    ``vals`` for its backward, which at ogb_products' 80 M edges holds a
    41 GB message tensor from the forward to the backward."""

    @staticmethod
    def forward(ctx, vals, idx, n):
        ctx.save_for_backward(idx)
        out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
        return out.index_add_(0, idx, vals)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad.index_select(0, idx), None, None


def _segsum(vals, idx, n):
    """Sum of ``vals`` rows into ``n`` rows by ``idx``."""
    return _SegmentSum.apply(vals, idx, n)


#: the process group the edges are split over (None: every edge here)
_EDGE_GROUP: list = [None]


@contextlib.contextmanager
def edges_split(group):
    """Within the block, the edge lists given to the forwards are this
    rank's slice of edges split over ``group``'s ranks (node state whole
    on each)."""
    _EDGE_GROUP.append(group)
    try:
        yield
    finally:
        _EDGE_GROUP.pop()


def _all_reduce(x):
    import torch.distributed as dist

    dist.all_reduce(x, group=_EDGE_GROUP[-1])
    return x


class _EdgeSum(torch.autograd.Function):
    """:class:`_SegmentSum` over a rank's edges, summed over the ranks:
    the forward all-reduces the partial sums, the backward gathers the
    (whole, replicated) gradient's rows by this rank's ``idx``."""

    @staticmethod
    def forward(ctx, vals, idx, n):
        ctx.save_for_backward(idx)
        out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
        return _all_reduce(out.index_add_(0, idx, vals))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad.index_select(0, idx), None, None


class _Fanout(torch.autograd.Function):
    """A replicated tensor entering rank-local edge work: identity
    forward, the ranks' partial gradients all-reduced backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


def _edge_sum(vals, idx, n):
    """Sum of per-edge ``vals`` into ``n`` node rows by ``idx`` (an edge
    end), over every rank's edges when they are split."""
    if _EDGE_GROUP[-1] is None:
        return _SegmentSum.apply(vals, idx, n)
    return _EdgeSum.apply(vals, idx, n)


def _to_edges(x):
    """A replicated tensor (or a dict of them) as rank-local edge work
    reads it."""
    if _EDGE_GROUP[-1] is None:
        return x
    if isinstance(x, torch.Tensor):
        return _Fanout.apply(x)
    return {k: _to_edges(x[k]) for k in x.keys()}


def _gather(x, idx):
    """Rows of replicated ``x`` at an edge end ``idx``."""
    return _to_edges(x).index_select(0, idx)


def _degree(dst, n):
    return _edge_sum(torch.ones(dst.shape, dtype=F32, device=dst.device),
                     dst, n).clamp_min(1.0)


# ================================================================= GraphSAGE
def graphsage_param_specs(cfg: GNNConfig, d_in: int) -> dict:
    d = cfg.d_hidden
    dims = [d_in] + [d] * cfg.n_layers
    layers = {}
    for i in range(cfg.n_layers):
        layers[f"l{i}"] = {
            "w_self": Spec((dims[i], d), F32, ("embed", "mlp")),
            "w_nbr": Spec((dims[i], d), F32, ("embed", "mlp")),
            "b": Spec((d,), F32, ("mlp",), init="zeros"),
        }
    layers["head"] = Spec((d, cfg.num_classes), F32, ("mlp", None))
    return layers


def graphsage_forward(params, cfg: GNNConfig, x, src, dst, n):
    deg = _degree(dst, n)[:, None]
    h = x
    for i in range(cfg.n_layers):
        p = params[f"l{i}"]
        agg = _edge_sum(_gather(h, src), dst, n) / deg
        h = torch.relu(h @ p["w_self"] + agg @ p["w_nbr"] + p["b"])
    return h @ params["head"]


# ====================================================================== GCN
def gcn_param_specs(cfg: GNNConfig, d_in: int) -> dict:
    d = cfg.d_hidden
    dims = [d_in] + [d] * cfg.n_layers
    layers = {
        f"l{i}": {"w": Spec((dims[i], d), F32, ("embed", "mlp")),
                  "b": Spec((d,), F32, ("mlp",), init="zeros")}
        for i in range(cfg.n_layers)
    }
    layers["head"] = Spec((d, cfg.num_classes), F32, ("mlp", None))
    return layers


def gcn_forward(params, cfg: GNNConfig, x, src, dst, n):
    deg = _degree(dst, n)
    coef = (1.0 / torch.sqrt(_gather(deg, src) * _gather(deg, dst)))[:, None]
    h = x
    for i in range(cfg.n_layers):
        p = params[f"l{i}"]
        msg = _edge_sum(_gather(h, src) * coef, dst, n)
        h = torch.relu(msg @ p["w"] + p["b"])
    return h @ params["head"]


# =================================================================== SchNet
def schnet_param_specs(cfg: GNNConfig, d_in: int = 0) -> dict:
    d, R = cfg.d_hidden, cfg.n_rbf
    sp = {"embed": Spec((100, d), F32, (None, "embed"), scale=1.0)}  # z <= 100
    for i in range(cfg.n_layers):
        sp[f"int{i}"] = {
            "filter": _mlp_specs(R, d, d, (None, "mlp", "embed")),
            "w_in": Spec((d, d), F32, ("embed", "mlp")),
            "out": _mlp_specs(d, d, d),
        }
    sp["readout"] = _mlp_specs(d, d // 2, 1, ("embed", "mlp", None))
    return sp


def _rbf_expand(dist, n_rbf, cutoff):
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=F32, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


def schnet_forward(params, cfg: GNNConfig, z, pos, src, dst, n):
    """Returns per-atom energies (n,); pooling happens in the loss.  The
    distance keeps the reference's 1e-9 inside the norm, so a self-loop or
    padded edge (difference 0) has a finite gradient."""
    h = params["embed"].index_select(0, z.clamp(0, 99))
    dist = torch.linalg.vector_norm(
        _gather(pos, src) - _gather(pos, dst) + 1e-9, dim=-1)
    rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    for i in range(cfg.n_layers):
        p = params[f"int{i}"]
        w = _mlp(_to_edges(p["filter"]), rbf)      # (E, d) cfconv filter
        msg = _edge_sum(_gather(h @ p["w_in"], src) * w, dst, n)
        h = h + _mlp(p["out"], msg)
    return _mlp(params["readout"], h)[:, 0]


# ===================================================================== EGNN
def egnn_param_specs(cfg: GNNConfig, d_in: int) -> dict:
    d = cfg.d_hidden
    sp = {"embed_in": Spec((d_in, d), F32, ("embed", "mlp"))}
    for i in range(cfg.n_layers):
        sp[f"l{i}"] = {
            "edge": _mlp_specs(2 * d + 1, d, d, (None, "mlp", "embed")),
            "coord": _mlp_specs(d, d, 1, ("embed", "mlp", None)),
            "node": _mlp_specs(2 * d, d, d, (None, "mlp", "embed")),
        }
    sp["head"] = _mlp_specs(d, d, 1, ("embed", "mlp", None))
    return sp


def egnn_forward(params, cfg: GNNConfig, x, pos, src, dst, n):
    """Returns (per-node energies (n,), updated positions).  Each layer
    makes new ``h`` and ``pos`` tensors (nothing autograd saved is
    written in place)."""
    h = x @ params["embed_in"]
    deg = _degree(dst, n)[:, None]
    for i in range(cfg.n_layers):
        p = params[f"l{i}"]
        hs, hd = _gather(h, src), _gather(h, dst)
        rel = _gather(pos, dst) - _gather(pos, src)
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        m = _mlp(_to_edges(p["edge"]), torch.cat([hd, hs, d2], dim=-1))
        # E(n)-equivariant coordinate update
        cw = _mlp(_to_edges(p["coord"]), m)                    # (E, 1)
        pos = pos + _edge_sum(rel * cw, dst, n) / deg
        agg = _edge_sum(m, dst, n)
        h = h + _mlp(p["node"], torch.cat([h, agg], dim=-1))
    return _mlp(params["head"], h)[:, 0], pos


# ------------------------------------------------------------------- losses
def gnn_param_specs(cfg: GNNConfig, d_in: int) -> dict:
    return {
        "graphsage": graphsage_param_specs,
        "gcn": gcn_param_specs,
        "schnet": lambda c, d: schnet_param_specs(c),
        "egnn": egnn_param_specs,
    }[cfg.arch](cfg, d_in)


def gnn_loss(params, cfg: GNNConfig, batch: dict) -> torch.Tensor:
    """Unified train loss across archs, modes, and shape cells.

    Every mode is an edge list over a node set of ``batch["num_nodes"]``
    rows: full-graph cells use the whole graph; ``minibatch_lg`` uses the
    flattened sampled subgraph with the B seed nodes first (loss over seeds
    only); ``molecule`` uses a batched disjoint union with ``graph_ids``
    pooling.  Classification (GraphSAGE, GCN) is the mean cross-entropy of
    the first ``len(labels)`` rows; regression (SchNet, EGNN) the mean
    squared error against ``y``.
    """
    n = batch["num_nodes"]
    src, dst = batch["src"], batch["dst"]
    if cfg.arch == "graphsage":
        logits = graphsage_forward(params, cfg, batch["x"], src, dst, n)
    elif cfg.arch == "gcn":
        logits = gcn_forward(params, cfg, batch["x"], src, dst, n)
    elif cfg.arch == "schnet":
        node_out = schnet_forward(params, cfg, batch["z"], batch["pos"], src,
                                  dst, n)
    elif cfg.arch == "egnn":
        node_out, _ = egnn_forward(params, cfg, batch["x"], batch["pos"],
                                   src, dst, n)
    else:
        raise ValueError(cfg.arch)

    if cfg.arch in ("graphsage", "gcn"):
        labels = batch["labels"]
        B = labels.shape[0]
        return _xent(logits[:B], labels)  # seeds-first (or all nodes)
    # energy regression
    y = batch["y"]
    if "graph_ids" in batch:  # molecule: pool per graph
        e = _segsum(node_out, batch["graph_ids"], y.shape[0])
    else:
        e = node_out[: y.shape[0]]
    return torch.mean((e - y) ** 2)


def _xent(logits, labels):
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()
