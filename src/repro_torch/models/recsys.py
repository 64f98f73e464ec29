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
leaves them to XLA.  ``mind_train_loss`` is not ported yet.

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


def user_interests(params, cfg: RecsysConfig, hist_ids, profile_ids):
    """(B, hist_len) history + (B, fields, bag) profile -> (B, K, D)."""
    B = hist_ids.shape[0]
    D = cfg.embed_dim
    mask = hist_ids >= 0
    e = params["item_embed"][hist_ids.clamp(min=0).long()]
    e = e @ params["bilinear"]  # shared bilinear map (B2I)
    caps = dynamic_routing(e, mask, cfg.n_interests, cfg.capsule_iters)
    # profile: one EmbeddingBag per multi-hot field
    flat = profile_ids.reshape(B * cfg.n_profile_fields, -1)
    bags = ebk.embedding_bag(params["profile_embed"], flat,
                             mode="mean").reshape(B, cfg.n_profile_fields * D)
    prof = bags @ params["profile_proj"]  # (B, D)
    h = torch.cat([caps, prof[:, None, :].expand(caps.shape)], dim=-1)
    m = params["mlp"]
    return torch.relu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"]  # (B, K, D)


def label_aware_attention(caps, target_e, p: float = 2.0):
    """MIND eq. (6): soft attention of the label over interests."""
    s = torch.einsum("bkd,bd->bk", caps, target_e)
    w = torch.softmax((s.abs() + 1e-9) ** p * torch.sign(s), dim=-1)
    return torch.einsum("bk,bkd->bd", w, caps)


def mind_train_loss(params, cfg: RecsysConfig, batch: dict):
    """Sampled softmax: target vs `num_sampled_negatives` uniform negatives."""
    caps = user_interests(params, cfg, batch["hist_ids"], batch["profile_ids"])
    table = params["item_embed"]
    tgt = table[batch["target_id"].long()]                        # (B, D)
    user = label_aware_attention(caps, tgt)
    negs = table[batch["negative_ids"].long()]                    # (B, M, D)
    pos_logit = torch.einsum("bd,bd->b", user, tgt)[:, None]
    neg_logit = torch.einsum("bd,bmd->bm", user, negs)
    logits = torch.cat([pos_logit, neg_logit], dim=1)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[:, 0].mean()


def mind_serve(params, cfg: RecsysConfig, batch: dict):
    """Online inference: user interest vectors (serve_p99 / serve_bulk)."""
    return user_interests(params, cfg, batch["hist_ids"],
                          batch["profile_ids"])


def mind_retrieval(params, cfg: RecsysConfig, batch: dict, top_k: int = 100):
    """Score one user's interests against `n_candidates` items (batched
    dot); returns ``(values, indices)`` of the top ``top_k``."""
    caps = user_interests(params, cfg, batch["hist_ids"],
                          batch["profile_ids"])
    cand = params["item_embed"][batch["candidate_ids"].long()]  # (C, D)
    scores = torch.einsum("bkd,cd->bkc", caps, cand).amax(dim=1)  # (B, C)
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
