"""Seeded edge-update batches for maintenance checks, drawn by numpy.

The seven differential families of the reference's maintenance battery
(``tests/test_parallel_maint.py``), and the mixed insert/delete stream of
``repro/stream/workload.py``, drawn with vectorised numpy over the graph's
sorted edge keys instead of Python edge sets, so they stay quick at the
edge counts the card runs (millions).  The draws differ from the
reference's; the shapes are the same:

* ``insert_sparse`` — 16 fresh edges;
* ``delete_sparse`` — 16 present edges deleted;
* ``mixed`` — two consecutive batches of 16, each op a delete of a live
  edge or an insert of a fresh one with even odds;
* ``clique_lift`` — the missing edges of a clique on the 7 lowest-degree
  nodes (multi-level rises);
* ``hub_churn`` — 6 edges of the highest-degree node deleted, 6 fresh ones
  inserted (one overlapping group);
* ``cascade_delete`` — up to 16 edges with an endpoint in the max core;
* ``reinsert`` — 8 edges deleted and re-inserted in one batch, plus 4
  fresh inserts.

``light_batch`` draws deletes plus inserts whose candidate sets stay
under the grouped settle's cap, so a full-width graph settles them in the
masked fixpoint rather than the serial fallback.

Every batch is a list of wire ops ``[kind, u, v]`` (``UpdateBatch.
from_wire``), ``u < v``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["FAMILIES", "families", "light_batch", "mixed_batch"]


def _keys(g) -> tuple:
    """(edges (m, 2) with u < v, their sorted int64 keys u * n + v)."""
    e = g.edge_list()
    n64 = np.int64(max(g.n, 1))
    return e, e[:, 0] * n64 + e[:, 1]  # edge_list is sorted by (u, v)


def _present(keys: np.ndarray, cand: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(keys, cand)
    pos = np.minimum(pos, max(len(keys) - 1, 0))
    return (keys[pos] == cand) if len(keys) else np.zeros(len(cand), bool)


def _fresh(g, keys, rng, k: int, taken=(), *, hub: int | None = None):
    """``k`` distinct edges absent from the graph and from ``taken`` (a
    key array), in draw order; with ``hub`` every edge has it as one
    endpoint."""
    n64 = np.int64(max(g.n, 1))
    taken = np.asarray(taken, dtype=np.int64)
    out = np.empty(0, dtype=np.int64)
    while len(out) < k:
        draws = 2 * (k - len(out)) + 64
        u = rng.integers(g.n, size=draws) if hub is None else \
            np.full(draws, hub)
        v = rng.integers(g.n, size=draws)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        cand = (lo * n64 + hi)[lo != hi]
        cand = cand[~_present(keys, cand) & ~np.isin(cand, taken)
                    & ~np.isin(cand, out)]
        _, first = np.unique(cand, return_index=True)
        out = np.concatenate([out, cand[np.sort(first)]])
    out = out[:k]
    return np.stack([out // n64, out % n64], axis=1)


def _ops(kind: str, edges) -> list:
    return [[kind, int(u), int(v)] for u, v in edges]


def _insert_sparse(g, rng, core):
    e, keys = _keys(g)
    return [_ops("+", _fresh(g, keys, rng, 16))]


def _delete_sparse(g, rng, core):
    e, _ = _keys(g)
    return [_ops("-", e[rng.choice(len(e), 16, replace=False)])]


def _mixed(g, rng, core):
    e, keys = _keys(g)
    n64 = np.int64(max(g.n, 1))
    order = rng.permutation(len(e))  # deletes walk a shuffled edge list
    used = 0
    inserted = np.empty(0, dtype=np.int64)
    out = []
    for _ in range(2):  # two consecutive batches: state carries over
        dels = rng.random(16) < 0.5
        nd = int(dels.sum())
        gone = e[order[used:used + nd]]
        used += nd
        new = _fresh(g, keys, rng, 16 - nd, inserted)
        inserted = np.concatenate([inserted, new[:, 0] * n64 + new[:, 1]])
        ops, di, ii = [], 0, 0
        for d in dels:
            if d:
                ops.append(["-", int(gone[di, 0]), int(gone[di, 1])])
                di += 1
            else:
                ops.append(["+", int(new[ii, 0]), int(new[ii, 1])])
                ii += 1
        out.append(ops)
    return out


def _clique_lift(g, rng, core):
    e, keys = _keys(g)
    nodes = np.argsort(g.degrees(), kind="stable")[:7]
    n64 = np.int64(max(g.n, 1))
    pairs = [(min(a, b), max(a, b)) for i, a in enumerate(nodes.tolist())
             for b in nodes[i + 1:].tolist()]
    cand = np.array(pairs, dtype=np.int64).reshape(-1, 2)
    missing = ~_present(keys, cand[:, 0] * n64 + cand[:, 1])
    return [_ops("+", cand[missing])]


def _hub_churn(g, rng, core):
    e, keys = _keys(g)
    hub = int(np.argmax(g.degrees()))
    nb = np.sort(g.neighbors(hub).astype(np.int64))[:6]
    gone = np.stack([np.minimum(nb, hub), np.maximum(nb, hub)], axis=1)
    return [_ops("-", gone) + _ops("+", _fresh(g, keys, rng, 6, hub=hub))]


def _cascade_delete(g, rng, core):
    e, _ = _keys(g)
    top = core == core.max()
    return [_ops("-", e[top[e[:, 0]] | top[e[:, 1]]][:16])]


def _reinsert(g, rng, core):
    e, keys = _keys(g)
    victims = e[rng.choice(len(e), 8, replace=False)]
    return [_ops("-", victims) + _ops("+", victims)
            + _ops("+", _fresh(g, keys, rng, 4))]


FAMILIES = {
    "insert_sparse": _insert_sparse,
    "delete_sparse": _delete_sparse,
    "mixed": _mixed,
    "clique_lift": _clique_lift,
    "hub_churn": _hub_churn,
    "cascade_delete": _cascade_delete,
    "reinsert": _reinsert,
}


def families(g, core, seed: int = 29) -> dict:
    """Every family's batches on ``g`` (``core`` its decomposition), each
    family drawn from its own ``default_rng(seed)``."""
    return {name: fam(g, np.random.default_rng(seed), np.asarray(core))
            for name, fam in FAMILIES.items()}


def mixed_batch(g, num_updates: int, seed: int = 0,
                p_delete: float = 0.45) -> list:
    """One batch of ``num_updates`` ops, each a delete (odds ``p_delete``)
    of a distinct present edge or an insert of a distinct fresh one."""
    rng = np.random.default_rng(seed)
    e, keys = _keys(g)
    dels = rng.random(num_updates) < p_delete
    nd = int(dels.sum())
    gone = e[rng.choice(len(e), nd, replace=False)]
    new = _fresh(g, keys, rng, num_updates - nd)
    src = np.empty((num_updates, 2), dtype=np.int64)
    src[dels] = gone
    src[~dels] = new
    kinds = np.where(dels, "-", "+")
    return [[str(k), int(u), int(v)] for k, (u, v) in zip(kinds, src)]


def light_batch(g, core, cnt, num_deletes: int, num_inserts: int,
                seed: int = 0, cap: int = 2048) -> list:
    """``num_deletes`` deletes of distinct present edges, then up to
    ``num_inserts`` inserts of fresh edges that the grouped settle plans
    under ``cap`` (``core``, ``cnt`` the graph's exact state).

    An insert (u, v) with ``core[u] = c < core[v]`` roots at u alone, and
    its candidate set lies in the level-c purecore set ``S_c`` (core c,
    cnt >= c + 1); a rise of u re-roots at level c + 1, inside ``S_c`` and
    ``S_{c+1}``.  So u is drawn, without repeats, from the levels with
    ``|S_c| + |S_{c+1}| <= cap``, and v from the nodes above u's level.
    Fewer inserts when fewer such u exist.
    """
    rng = np.random.default_rng(seed)
    e, keys = _keys(g)
    n64 = np.int64(max(g.n, 1))
    core = np.asarray(core, dtype=np.int64)
    cnt = np.asarray(cnt, dtype=np.int64)
    gone = e[rng.choice(len(e), num_deletes, replace=False)]
    pure = cnt >= core + 1
    size = np.bincount(core[pure], minlength=int(core.max(initial=0)) + 2)
    light = size[:-1] + size[1:] <= cap  # per level c
    pool = np.flatnonzero(pure & light[core] & (core < core.max(initial=0)))
    u = rng.permutation(pool)[:num_inserts]
    by_core = np.argsort(core, kind="stable")
    above = np.searchsorted(core[by_core], core[u], side="right")
    v = np.empty(len(u), dtype=np.int64)
    todo = np.arange(len(u))
    while len(todo):  # redraw the v that give a present or repeated edge
        v[todo] = by_core[rng.integers(above[todo], g.n)]
        key = np.minimum(u, v) * n64 + np.maximum(u, v)
        _, first = np.unique(key, return_index=True)
        fresh = np.zeros(len(u), dtype=bool)
        fresh[first] = True
        todo = np.flatnonzero(_present(keys, key) | ~fresh)
    new = np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1)
    return _ops("-", gone) + _ops("+", new)
