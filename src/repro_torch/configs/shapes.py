"""Shape cells of the ported families and the inputs of each cell.

The port's copy of ``repro/configs/shapes.py`` for the LM and recsys
families: the cell tables, :func:`lm_specs` and :func:`recsys_specs`, the
counterparts of ``_lm_specs`` and ``_recsys_specs``, as plain ``(shape,
dtype)`` tuples, and :func:`input_specs` over both.
"""
from __future__ import annotations

import torch

from .base import LMConfig, RecsysConfig

__all__ = ["LM_SHAPES", "RECSYS_SHAPES", "lm_specs", "recsys_specs",
           "input_specs"]

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, step="train"),
    "serve_p99": dict(batch=512, step="serve"),
    "serve_bulk": dict(batch=262_144, step="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, step="retrieval"),
}


def lm_specs(cfg: LMConfig, shape_name: str, reduced: bool = False) -> dict:
    """Input name -> ``(shape, dtype)`` of one LM cell; a decode cell's
    ``caches`` are :func:`~repro_torch.models.transformer.make_kv_cache_specs`
    (MLA's latent caches for an MLA config)."""
    from ..models.transformer import make_kv_cache_specs

    sh = LM_SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    if reduced:
        B, S = min(B, 2), min(S, 64)
    i32 = torch.int32
    if sh["step"] == "train":
        return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
    if sh["step"] == "prefill":
        return {"tokens": ((B, S), i32)}
    # decode: one new token against a cache of length seq_len
    return {"tokens": ((B, 1), i32), "caches": make_kv_cache_specs(cfg, B, S)}


def recsys_specs(cfg: RecsysConfig, shape_name: str,
                 reduced: bool = False) -> dict:
    """Input name -> ``(shape, dtype)`` of one recsys cell."""
    sh = RECSYS_SHAPES[shape_name]
    B = sh["batch"] if not reduced else 4
    i32 = torch.int32
    base = {
        "hist_ids": ((B, cfg.hist_len), i32),
        "profile_ids": ((B, cfg.n_profile_fields, cfg.profile_bag), i32),
    }
    if sh["step"] == "train":
        base |= {"target_id": ((B,), i32),
                 "negative_ids": ((B, cfg.num_sampled_negatives), i32)}
    if sh["step"] == "retrieval":
        C = sh["n_candidates"] if not reduced else 64
        base |= {"candidate_ids": ((C,), i32)}
    return base


def input_specs(cfg, shape_name: str, *, reduced: bool = False):
    """``(step_kind, avals)`` of one cell of ``cfg``'s family.  The GNN
    cells wait for ROADMAP Queue 1 item 7.6, the sharded core-graph cells
    for ``launch/`` (item 7.7)."""
    if cfg.kind == "lm":
        return (LM_SHAPES[shape_name]["step"],
                lm_specs(cfg, shape_name, reduced))
    if cfg.kind == "recsys":
        return (RECSYS_SHAPES[shape_name]["step"],
                recsys_specs(cfg, shape_name, reduced))
    if cfg.kind == "gnn":
        raise NotImplementedError("GNN cells are not ported yet (ROADMAP "
                                  "Queue 1 item 7.6)")
    if cfg.kind == "coregraph":
        raise NotImplementedError("sharded core-graph cells are not ported "
                                  "yet (ROADMAP Queue 1 item 7.7)")
    raise ValueError(cfg.kind)
