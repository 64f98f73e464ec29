"""MIND: Multi-Interest Network with Dynamic Routing (Li et al., CIKM'19).

The port's copy of ``repro/models/recsys.py``: user behavior
sequence -> B2I dynamic-routing capsules (n_interests), the profile's
multi-hot fields through the EmbeddingBag kernel (``kernels/
embedding_bag.py``), an MLP per interest; retrieval scores candidates by
max-over-interests dot product + top-k; training is the label-aware
attention's sampled softmax (:func:`mind_train_loss`).  The public functions keep the
reference's signatures and layouts (``hist_ids (B, hist_len)``,
``profile_ids (B, fields, bag)``, interests ``(B, K, D)``); ``params`` is
the :class:`~repro_torch.models.params.ParamTree` of
:func:`mind_param_specs` (or nested dicts of tensors under the same
names).  On CUDA tensors the profile bags run the hand-written kernel.
Item gathers and the matrix products stay torch ops, as the reference
leaves them to XLA.

With ``tp`` (a ``layers.TensorParallel`` over the mesh's ``model`` axis;
serving and training) ``params`` are this rank's pieces by the
reference's rules: ``item_embed`` and ``profile_embed`` rows ``[index *
R, (index + 1) * R)`` of R a rank, the MLP's ``w1`` columns and ``b1`` in pieces, ``w2``'s rows,
``bilinear``, ``profile_proj`` and ``b2`` whole.  The history gather reads
the ids a rank owns, zeros elsewhere, and sums over the ranks (one
non-zero term an element: exact).  The profile bags run the kernel in
``sum`` mode on a rank's rows, the ids it does not own masked, and the
partial bags are summed over the ranks and divided by the global count of
valid slots.  Retrieval scores the candidates a rank owns, 0 elsewhere,
and sums the scores over the ranks.  The MLP's second product is summed
over the ranks before ``b2``.  Under autograd (:func:`mind_train_loss`
over ``model``) these sums are Megatron's *g* (identity backward, so a
rank's rows get the gradient of the rows it holds), ``tp.copy_to`` (*f*)
precedes ``w1``, and the bags' backward (``kernels.embedding_bag.
bag_backward``, plain torch) adds exactly 0 to the piece for a masked
slot.

:func:`serve_step` and :func:`retrieval_step` are the entry points of the
reference's recsys serve and retrieval steps (``launch/steps.py``), on one
device, under ``torch.inference_mode()``.  They refuse ids past their
table in a host batch before it moves to the device, where the check would
cost a sync; ids given as device tensors are the caller's to keep in
range (an item gather past the table faults; the bag kernel reads nothing
and flags it, see ``embedding_bag.raise_bad_index``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import RecsysConfig
from ..kernels import embedding_bag as ebk
from .params import Spec, tree_init

__all__ = ["mind_param_specs", "mind_init", "dynamic_routing",
           "user_interests", "label_aware_attention", "mind_train_loss",
           "mind_serve",
           "mind_retrieval", "serve_step", "retrieval_step"]

F32 = torch.float32


def mind_param_specs(cfg: RecsysConfig) -> dict:
    D = cfg.embed_dim
    return {
        "item_embed": Spec((cfg.n_items, D), F32, ("rows", "embed"), scale=0.1),
        "profile_embed": Spec((cfg.profile_vocab, D), F32, ("rows", "embed"),
                              scale=0.1),
        "bilinear": Spec((D, D), F32, ("embed", "embed2")),  # routing S matrix
        "profile_proj": Spec((cfg.n_profile_fields * D, D), F32, (None, "embed")),
        "mlp": {
            "w1": Spec((2 * D, cfg.mlp_dim), F32, ("embed", "mlp")),
            "b1": Spec((cfg.mlp_dim,), F32, ("mlp",), init="zeros"),
            "w2": Spec((cfg.mlp_dim, D), F32, ("mlp", "embed")),
            "b2": Spec((D,), F32, ("embed",), init="zeros"),
        },
    }


def mind_init(cfg: RecsysConfig, generator: torch.Generator):
    """MIND's parameters on ``generator.device``, drawn from it."""
    return tree_init(mind_param_specs(cfg), generator)


def _squash(z, dim=-1):
    n2 = (z * z).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


def dynamic_routing(e, mask, n_interests: int, iters: int):
    """B2I routing: behaviors e (B, L, D) -> interest capsules (B, K, D)."""
    B, L, D = e.shape
    K = n_interests
    logits = torch.zeros((B, K, L), dtype=F32, device=e.device)
    caps = torch.zeros((B, K, D), dtype=F32, device=e.device)
    m = mask[:, None, :]
    for _ in range(iters):
        w = torch.softmax(torch.where(m, logits, -1e30), dim=1)
        z = torch.einsum("bkl,bld->bkd", w * m, e)
        caps = _squash(z)
        logits = logits + torch.einsum("bkd,bld->bkl", caps, e)
    return caps


def _owned(ids, rows: int, tp):
    """``(local, mine)``: ``ids`` (int) as indices into this rank's piece
    of ``rows`` rows of a table cut by rows over ``tp``'s ranks, and where
    this rank holds them.  CPU ids at or past the whole table raise, as
    the one-device gather does."""
    if ids.device.type == "cpu" and ids.numel() \
            and int(ids.max()) >= rows * tp.size:
        raise IndexError(f"an id is >= the table's {rows * tp.size} rows")
    local = ids.long() - tp.index * rows
    return local, (local >= 0) & (local < rows)


def _gather_rows(table, ids, tp=None):
    """``table[ids]``; with ``tp``, from this rank's row piece, the rows it
    does not hold zero, summed over the ranks (exact: one non-zero term).
    An id this rank does not hold reads row ``id mod R`` of its R rows and
    drops it: under autograd its zero gradient then lands on spread rows,
    not on one row that every such id would share (which the card's
    ``index_put`` backward adds up one id after another)."""
    if tp is None:
        return table[ids.long()]
    rows = table.shape[0]
    local, mine = _owned(ids, rows, tp)
    part = torch.where(mine[..., None], table[local.remainder(rows)], 0.0)
    return tp.reduce(part)


def _profile_bags(table, flat, tp=None):
    """The mean bags of ``flat`` (bags, slots) over the profile table; with
    ``tp``, the kernel's ``sum`` bags of the ids this rank holds (the rest
    masked; an id past the whole table kept past the piece, so it is
    refused as it is on one device), summed over the ranks and divided by
    the global count of valid slots, at least 1e-9 (``kernels/ref.py``)."""
    if tp is None:
        return ebk.embedding_bag(table, flat, mode="mean")
    rows = table.shape[0]
    local, mine = _owned(flat, rows, tp)
    past = flat >= rows * tp.size
    local = torch.where(mine | past, local, -1).to(torch.int32)
    bags = tp.reduce(ebk.embedding_bag(table, local, mode="sum"))
    count = (flat >= 0).sum(dim=1, keepdim=True).to(bags.dtype)
    return bags / count.clamp(min=1e-9)


def user_interests(params, cfg: RecsysConfig, hist_ids, profile_ids,
                   tp=None):
    """(B, hist_len) history + (B, fields, bag) profile -> (B, K, D); with
    ``tp`` on this rank's parameter pieces (module docstring)."""
    B = hist_ids.shape[0]
    D = cfg.embed_dim
    mask = hist_ids >= 0
    e = _gather_rows(params["item_embed"], hist_ids.clamp(min=0), tp)
    e = e @ params["bilinear"]  # shared bilinear map (B2I)
    caps = dynamic_routing(e, mask, cfg.n_interests, cfg.capsule_iters)
    # profile: one EmbeddingBag per multi-hot field
    flat = profile_ids.reshape(B * cfg.n_profile_fields, -1)
    bags = _profile_bags(params["profile_embed"], flat, tp).reshape(
        B, cfg.n_profile_fields * D)
    prof = bags @ params["profile_proj"]  # (B, D)
    h = torch.cat([caps, prof[:, None, :].expand(caps.shape)], dim=-1)
    m = params["mlp"]
    if tp is not None:  # w1's columns over the ranks: f before them
        h = tp.copy_to(h)
    out = torch.relu(h @ m["w1"] + m["b1"]) @ m["w2"]
    if tp is not None:  # w2's rows over the ranks: sum the partial products
        out = tp.reduce(out)
    return out + m["b2"]  # (B, K, D)


def label_aware_attention(caps, target_e, p: float = 2.0):
    """MIND eq. (6): soft attention of the label over interests."""
    s = torch.einsum("bkd,bd->bk", caps, target_e)
    w = torch.softmax((s.abs() + 1e-9) ** p * torch.sign(s), dim=-1)
    return torch.einsum("bk,bkd->bd", w, caps)


def mind_train_loss(params, cfg: RecsysConfig, batch: dict, tp=None):
    """Sampled softmax: target vs `num_sampled_negatives` uniform
    negatives; with ``tp`` on this rank's parameter pieces (module
    docstring), the target and negative rows gathered as the history's."""
    caps = user_interests(params, cfg, batch["hist_ids"], batch["profile_ids"],
                          tp)
    table = params["item_embed"]
    tgt = _gather_rows(table, batch["target_id"], tp)             # (B, D)
    user = label_aware_attention(caps, tgt)
    negs = _gather_rows(table, batch["negative_ids"], tp)         # (B, M, D)
    pos_logit = torch.einsum("bd,bd->b", user, tgt)[:, None]
    neg_logit = torch.einsum("bd,bmd->bm", user, negs)
    logits = torch.cat([pos_logit, neg_logit], dim=1)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[:, 0].mean()


def mind_serve(params, cfg: RecsysConfig, batch: dict, tp=None):
    """Online inference: user interest vectors (serve_p99 / serve_bulk)."""
    return user_interests(params, cfg, batch["hist_ids"],
                          batch["profile_ids"], tp)


def mind_retrieval(params, cfg: RecsysConfig, batch: dict, top_k: int = 100,
                   tp=None):
    """Score one user's interests against `n_candidates` items (batched
    dot); returns ``(values, indices)`` of the top ``top_k``.  With
    ``tp`` each rank scores the candidates whose rows it holds, 0 for the
    rest, and the scores are summed over the ranks."""
    caps = user_interests(params, cfg, batch["hist_ids"],
                          batch["profile_ids"], tp)
    ids, table = batch["candidate_ids"], params["item_embed"]
    if tp is None:
        cand = table[ids.long()]                                 # (C, D)
        scores = torch.einsum("bkd,cd->bkc", caps, cand).amax(dim=1)
    else:
        rows = table.shape[0]
        local, mine = _owned(ids, rows, tp)
        cand = table[local.clamp(0, rows - 1)]
        scores = tp.reduce(torch.where(mine, torch.einsum(
            "bkd,cd->bkc", caps, cand).amax(dim=1), 0.0))
    return torch.topk(scores, min(top_k, scores.shape[-1]), dim=-1)


#: the batch's id arrays and the config field giving each one's table rows
_ID_ROWS = (("hist_ids", "n_items"), ("profile_ids", "profile_vocab"),
            ("candidate_ids", "n_items"))


def _on_device(cfg: RecsysConfig, batch: dict, device) -> dict:
    """The batch on ``device``, its host id arrays checked first."""
    for key, rows in _ID_ROWS:
        ids = batch.get(key)
        if ids is None or (isinstance(ids, torch.Tensor)
                           and ids.device.type != "cpu"):
            continue
        ids, n = np.asarray(ids), getattr(cfg, rows)
        if ids.size and int(ids.max()) >= n:
            raise IndexError(f"{key}: an id is >= the table's {n} rows")
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def serve_step(params, cfg: RecsysConfig, batch: dict):
    """The recsys serve step: a batch of numpy or torch inputs, moved to
    the parameters' device -> interests (B, K, D)."""
    with torch.inference_mode():
        return mind_serve(params, cfg, _on_device(
            cfg, batch, params["item_embed"].device))


def retrieval_step(params, cfg: RecsysConfig, batch: dict, top_k: int = 100):
    """The recsys retrieval step -> (values, indices) of the top ``top_k``."""
    with torch.inference_mode():
        return mind_retrieval(params, cfg, _on_device(
            cfg, batch, params["item_embed"].device), top_k)
