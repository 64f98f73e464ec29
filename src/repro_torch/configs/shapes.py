"""Shape cells of the ported families and the inputs of each cell.

The port's copy of ``repro/configs/shapes.py`` for the LM, GNN and recsys
families: the cell tables, :func:`lm_specs`, :func:`gnn_specs` and
:func:`recsys_specs`, the counterparts of ``_lm_specs``, ``_gnn_specs`` and
``_recsys_specs``, as plain ``(shape, dtype)`` tuples, and
:func:`input_specs` over the three.
"""
from __future__ import annotations

import torch

from .base import GNNConfig, LMConfig, RecsysConfig

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "lm_specs",
           "gnn_specs", "recsys_specs", "input_specs"]

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          step="train", mode="full"),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602,
                         step="train", mode="sampled"),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         step="train", mode="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                     step="train", mode="molecule"),
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


def gnn_specs(cfg: GNNConfig, shape_name: str,
              reduced: bool = False) -> tuple:
    """``(batch, num_nodes)`` of one GNN cell: input name -> ``(shape,
    dtype)``, and the node count of the edge list.  A full-graph cell pads
    its edge axis to a multiple of 512 and adds a sink node ``N`` (padded
    edges point at it; losses read only real rows); a sampled cell is the
    flattened two-hop subgraph, its seeds first; a molecule cell is the
    disjoint union of ``batch`` small graphs."""
    sh = GNN_SHAPES[shape_name]
    mode = sh["mode"]
    i32, f32 = torch.int32, torch.float32
    if mode == "full":
        N, E, F = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
        if reduced:
            N, E, F = 64, 256, 8
        E = -(-E // 512) * 512
        N = N + 1
        batch = {"src": ((E,), i32), "dst": ((E,), i32)}
        if cfg.arch == "schnet":
            batch |= {"z": ((N,), i32), "pos": ((N, 3), f32),
                      "y": ((N,), f32)}
        elif cfg.arch == "egnn":
            batch |= {"x": ((N, F), f32), "pos": ((N, 3), f32),
                      "y": ((N,), f32)}
        else:
            batch |= {"x": ((N, F), f32), "labels": ((N - 1,), i32)}
        return batch, N
    if mode == "sampled":
        B = sh["batch_nodes"]
        f1, f2 = sh["fanout"]
        F = sh["d_feat"]
        if reduced:
            B, f1, f2, F = 8, 3, 2, 8
        N = B * (1 + f1 + f1 * f2)     # flattened sampled subgraph, seeds first
        E = 2 * (B * f1 + B * f1 * f2)  # both directions
        batch = {"src": ((E,), i32), "dst": ((E,), i32)}
        if cfg.arch == "schnet":
            batch |= {"z": ((N,), i32), "pos": ((N, 3), f32),
                      "y": ((B,), f32)}
        elif cfg.arch == "egnn":
            batch |= {"x": ((N, F), f32), "pos": ((N, 3), f32),
                      "y": ((B,), f32)}
        else:
            batch |= {"x": ((N, F), f32), "labels": ((B,), i32)}
        return batch, N
    # molecule: disjoint union of `batch` small graphs
    G = sh["batch"] if not reduced else 4
    n1, e1, F = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    N, E = G * n1, G * e1 * 2
    batch = {"src": ((E,), i32), "dst": ((E,), i32),
             "graph_ids": ((N,), i32), "y": ((G,), f32)}
    if cfg.arch == "schnet":
        batch |= {"z": ((N,), i32), "pos": ((N, 3), f32)}
    elif cfg.arch == "egnn":
        batch |= {"x": ((N, F), f32), "pos": ((N, 3), f32)}
    else:
        batch |= {"x": ((N, F), f32)}
        batch["labels"] = ((G,), i32)
        del batch["y"]
    return batch, N


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
    """``(step_kind, avals)`` of one cell of ``cfg``'s family; a GNN cell's
    avals are ``{"batch": ..., "num_nodes": N}`` (:func:`gnn_specs`).  The
    sharded core-graph cells wait for ``launch/`` (ROADMAP Queue 1 item
    7.7)."""
    if cfg.kind == "lm":
        return (LM_SHAPES[shape_name]["step"],
                lm_specs(cfg, shape_name, reduced))
    if cfg.kind == "recsys":
        return (RECSYS_SHAPES[shape_name]["step"],
                recsys_specs(cfg, shape_name, reduced))
    if cfg.kind == "gnn":
        batch, N = gnn_specs(cfg, shape_name, reduced)
        return GNN_SHAPES[shape_name]["step"], {"batch": batch,
                                                "num_nodes": N}
    if cfg.kind == "coregraph":
        raise NotImplementedError("sharded core-graph cells are not ported "
                                  "yet (ROADMAP Queue 1 item 7.7)")
    raise ValueError(cfg.kind)
