"""Plain-torch oracles, formula for formula the port's copies of
``repro/kernels/ref.py``.

``fused_superstep_ref``: h-index by an eager binary search over per-row
counts, the refreshed cnt by a >=-threshold row sum, the semicore* push
rule and the semicore+ touched rule, both summed over each row's own edges
(the row-summed form, which needs no symmetry of the edge table).  Rows
need not be sorted.

``embedding_bag_ref``: gather + masked weighted sum or mean; a masked slot
reads row 0 and multiplies it by 0, as the reference does.

``embedding_bag_slot_order`` is the port's own, with no counterpart
there: the unweighted bag summed slot by slot in float32, the order in
which the CUDA kernel sums (its fmaf with weight 1 is this add), so the
kernel equals it bit for bit.

``flash_decode_ref``: full masked softmax attention of one query token in
float32, the TPU kernel's ``(H, d)`` / ``(Hkv, S, d)`` layout.
"""
from __future__ import annotations

import torch

__all__ = ["fused_superstep_ref", "embedding_bag_ref",
           "embedding_bag_slot_order", "flash_decode_ref"]

NEG_INF = -1e30


def fused_superstep_ref(core, cnt, active, nbr, rows, num_segments: int,
                        algorithm: str):
    """Returns ``(core2, cnt2, active2, upd)`` as int32/bool tensors."""
    core = torch.as_tensor(core, dtype=torch.int32)
    cnt = torch.as_tensor(cnt, dtype=torch.int32) if cnt is not None else None
    active = torch.as_tensor(active, dtype=torch.bool)
    nbr = torch.as_tensor(nbr, dtype=torch.int64)
    rows = torch.as_tensor(rows, dtype=torch.int64)
    n = int(num_segments)

    def row_sum(x):
        return torch.zeros(n, dtype=torch.int32).index_add_(
            0, rows, x.to(torch.int32))

    nbr_vals = core[nbr]
    c_old = torch.where(active, core, 0)

    def count_ge(thresholds):
        return row_sum(nbr_vals >= thresholds[rows])

    cmax = int(c_old.max()) if n else 0
    h = torch.zeros(n, dtype=torch.int32)
    step = 1
    while step <= cmax:
        step <<= 1
    step >>= 1
    while step >= 1:
        cand = torch.minimum(h + step, c_old)
        h = torch.where(count_ge(cand) >= cand, cand, h)
        step >>= 1

    core2 = torch.where(active, h, core)
    upd = (active & (h != core)).sum(dtype=torch.int32)
    if algorithm == "semicore":
        return core2, cnt, active, upd
    if algorithm == "semicore+":
        touched = row_sum((active & (h != core))[nbr])
        return core2, cnt, (touched > 0) & (core2 > 0), upd
    refreshed = count_ge(torch.where(active, h, 0))
    c2_row = core2[rows]
    push = active[nbr] & (c2_row > h[nbr]) & (c2_row <= core[nbr])
    cnt2 = torch.where(active, refreshed, cnt) - row_sum(push)
    return core2, cnt2, (cnt2 < core2) & (core2 > 0), upd


def embedding_bag_ref(table, indices, weights, mode: str = "sum"):
    """``out[b] = Σ_l w[b,l]·table[idx[b,l]]`` with ``idx < 0`` masked;
    ``mode="mean"`` divides by ``max(Σ_l w, 1e-9)``."""
    mask = (indices >= 0).to(table.dtype)
    w = weights.to(table.dtype) * mask
    rows = table[indices.clamp(min=0).long()]  # (B, L, D)
    out = torch.einsum("bld,bl->bd", rows, w)
    if mode == "mean":
        out = out / w.sum(dim=1, keepdim=True).clamp(min=1e-9)
    return out


def embedding_bag_slot_order(table, indices, mode: str = "sum"):
    """Unweighted bags, each column's slots added in slot order in float32,
    one row gather a slot; a slot with an index < 0 or >= N adds nothing
    and does not count in the mean (at least 1e-9).  Rounded once to the
    table's dtype."""
    N = table.shape[0]
    acc = torch.zeros(indices.shape[0], table.shape[1], device=table.device)
    cnt = torch.zeros(indices.shape[0], 1, device=table.device)
    for col in indices.t():
        ok = ((col >= 0) & (col < N))[:, None]
        rows = table[col.clamp(0, N - 1).long()]
        acc = torch.where(ok, acc + rows.float(), acc)
        cnt = cnt + ok
    if mode == "mean":
        acc = acc / cnt.clamp(min=1e-9)
    return acc.to(table.dtype)


def flash_decode_ref(q, k, v, cache_len):
    """q (H, d), k/v (Hkv, S, d), the first ``cache_len`` positions valid;
    returns (H, d) in q's dtype."""
    H, d = q.shape
    Hkv, S, _ = k.shape
    qg = q.reshape(Hkv, H // Hkv, d).float()
    scores = torch.einsum("hgd,hsd->hgs", qg, k.float()) / (d ** 0.5)
    mask = torch.arange(S, device=q.device)[None, None, :] < cache_len
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgs,hsd->hgd", p, v.float())
    return out.reshape(H, d).to(q.dtype)
