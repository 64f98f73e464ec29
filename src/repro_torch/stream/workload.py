"""Synthetic mixed update streams for examples and tests.

The port's own copy of ``repro/stream/workload.py``.  It holds every edge
in a Python set, so it suits small graphs; at full width draw updates with
:func:`repro_torch.graph.update_cases.mixed_batch` instead.

Generates an always-valid insert/delete stream against the *evolving* edge
set (deletes pick a live edge, inserts pick a fresh non-edge), deterministic
in ``seed``.  Deleted-edge selection uses swap-remove over a mirrored edge
list, so generation is O(1) per op.
"""
from __future__ import annotations

import numpy as np

__all__ = ["mixed_stream"]


def mixed_stream(g, num_updates: int, seed: int = 0, p_delete: float = 0.45):
    """Return ``(ops, final_edges)``: the op list and the resulting edge set."""
    rng = np.random.default_rng(seed)
    present = {tuple(e) for e in g.edge_list().tolist()}
    ordered = sorted(present)
    ops = []
    for _ in range(num_updates):
        if ordered and rng.random() < p_delete:
            i = rng.integers(len(ordered))
            u, v = ordered[i]
            ordered[i] = ordered[-1]
            ordered.pop()
            present.discard((u, v))
            ops.append(("-", u, v))
        else:
            while True:
                u, v = int(rng.integers(g.n)), int(rng.integers(g.n))
                lo, hi = min(u, v), max(u, v)
                if u != v and (lo, hi) not in present:
                    break
            present.add((lo, hi))
            ordered.append((lo, hi))
            ops.append(("+", lo, hi))
    return ops, present
