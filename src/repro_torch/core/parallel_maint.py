"""Parallel independent-group maintenance settle.

The port's own copy of ``repro/core/parallel_maint.py``, in numpy, with
the same names and semantics; the one masked fixpoint per round runs on
the port's device backends (``resident.run_resident(...,
settle_mask=...)``: the fused superstep kernels on ``"cuda"``, the
per-probe segment sums with ``CudaBackend(fused=False)``).

The serial batch path settles every micro-batch with a full exact-cnt
prologue + SemiCore* warm settle — O(E) device work and a near-cold warm
start (``core0 + I``) no matter how local the updates are.  This module is
the batched alternative: bound the possible damage of every update (Li &
Yu, arXiv 1207.4567), partition the batch into independent groups (Wang et
al., arXiv 1612.09368), and settle *all* groups as one device-resident
masked fixpoint in which non-candidate nodes are frozen and the warm start
is exact on the insert side (a host-side peel of each candidate component).

Per-update candidate bound (all sets computed on the post-update graph,
levels w.r.t. the round-start cores; ``cnt`` is Eq. 2 and equals the
paper's mcd for a node at its own level):

* **Insert at level c** (``c = min(core0[u], core0[v])``): only nodes with
  ``core0 == c`` reachable from the root through nodes with ``core0 == c``
  and ``cnt >= c+1`` can rise, and by at most 1 (the purecore bound — a
  node with ``cnt <= c`` cannot reach ``c+1`` neighbors of rank ``c+1``
  and blocks propagation, and that exclusion is stable under same-level
  raises).  The candidate set is the root's *exact* purecore component,
  computed by whole-level label propagation over the flat merged adjacency
  — no per-node BFS, no lost-completeness cap.  An empty set (no endpoint
  qualifies) means nothing can rise.  A component larger than the cap is
  *heavy*: the round takes the serial warm-settle fallback.

* **Delete at level c**: a delete can only force drops, and drops cascade
  strictly *downward* in level (a node dropping from c supports exactly
  the thresholds in ``(core_new, c]``), so the prefix ``core0 <= c`` is a
  complete candidate set for any cascade the delete can start.  Deletes
  whose endpoints stay non-deficient after the structural cnt deltas are
  absorbed (nothing can change).  Prefix candidates cost nothing: they add
  no warm bump, so frozen-but-masked nodes never enter the frontier unless
  a cascade actually reaches them.

The rise set of a level-c component is resolved exactly *before* the
device settle by a host peel: start from the whole component optimistically
risen, and repeatedly drop every member whose support at ``c+1``
(neighbors with ``core0 >= c+1`` plus surviving co-members) falls short.
The greatest fixpoint of that shrinking iteration is precisely the rise
set the masked device fixpoint would grind out of a blanket ``c+1`` bump —
computed in O(component edges) on host instead of O(E)-per-pass on device,
and still a sound upper bound under concurrent deletes (drops only shrink
support, and the settle corrects from above).  Survivors are warmed to
``c+1`` and cnt is patched in one vectorized pass (a raised node crosses
the threshold of exactly its neighbors with ``core0`` in ``(old, warm]``;
raised nodes are recounted exactly against the warm values), then ONE
masked SemiCore* fixpoint settles every group —
``resident.run_resident(..., settle_mask=...)`` on device backends, a
thread-free warm-start seq settle on numpy.  Its initial frontier is the
delete-deficient set only: the insert side arrives pre-settled.

Two inserts can *compound* — a level-c raise bumps the threshold-(c+1)
support of a node no component admitted, newly qualifying it for the
level-(c+1) riser structure, past the per-insert +1 bound.  Instead of
merging and serializing such groups up front, the settle runs **saturation
rounds**: after each round, any node that actually rose becomes a root for
the next round, re-planned on the settled state (same graph, same resident
structure — nothing is undone or re-applied).  A missed rise always has a
minimal-level witness that passes the purecore test on the settled state
and is connected to a prior riser or insert endpoint through its level
component (else the rise was available before the batch, contradicting the
pre-batch exactness), so re-rooting at risers is complete; each extra
round strictly raises some core, so the loop terminates.  In the common
case round 2 finds no qualifying roots and plans nothing.

Convergence-from-above with a frozen boundary is exact iff the frozen
values are; the feasibility certificate ``all(cnt >= core)`` checks
exactly that (the settle keeps cnt exact *everywhere*, frozen nodes
included, via the push rule), and a violation escalates the round to the
serial warm settle — so the result is bit-identical to the serial oracle
by construction, which the differential battery asserts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs import metrics as _metrics, trace as _trace
from .engine import resident_on, warm_settle

__all__ = ["DEFAULT_GROUP_CAP", "UpdateCand", "BatchPlan", "plan_batch",
           "grouped_settle"]

#: candidate-set cap per group: an insert whose purecore component exceeds
#: this is *heavy* and sends the round to the serial warm-settle fallback
DEFAULT_GROUP_CAP = 2048

#: hard bound on saturation rounds (every extra round strictly raises some
#: core, so this only guards a planner bug)
_MAX_ROUNDS = 64

_GROUPS_SETTLED = _metrics.counter(
    "repro_maintenance_groups_total",
    "Independent maintenance groups planned by the parallel settle",
).labels(outcome="settled")
_GROUPS_FALLBACK = _metrics.counter(
    "repro_maintenance_groups_total",
    "Independent maintenance groups planned by the parallel settle",
).labels(outcome="fallback")
_GROUP_SIZE = _metrics.histogram(
    "repro_maintenance_group_size_nodes",
    "Candidate-set size per planned maintenance group",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)
_ESCALATIONS = _metrics.counter(
    "repro_maintenance_escalations_total",
    "Masked settles whose feasibility certificate failed (serial redo)",
)
_ROUNDS = _metrics.histogram(
    "repro_maintenance_settle_rounds",
    "Saturation rounds needed to settle one micro-batch",
    buckets=(1, 2, 3, 4, 6, 8, 16),
)


@dataclass
class UpdateCand:
    """One applied update (or riser re-root) with its candidate bound."""

    kind: str              # "+" insert, "-" delete, "^" riser re-root
    u: int
    v: int
    level: int             # min(core0[u], core0[v]); riser: its new core
    op: int                # position in the applied order (-1: re-root)
    cand: np.ndarray       # candidate node ids (empty: absorbed or prefix)
    prefix_level: int = -1  # >= 0: candidates are {x : core0[x] <= level}
    size: int = 0          # true candidate count (prefix included)
    heavy: bool = False    # insert component exceeded the cap


@dataclass
class BatchPlan:
    """One round's updates and their independent-group partition."""

    updates: list = field(default_factory=list)   # UpdateCand, applied order
    groups: list = field(default_factory=list)    # lists of UpdateCand

    @property
    def heavy(self) -> bool:
        return any(up.heavy for up in self.updates)

    @property
    def largest_group(self) -> int:
        sizes = [sum(up.size for up in g) for g in self.groups]
        return max(sizes, default=0)


class _Arrays:
    """One batch's planning snapshot: the flat merged adjacency."""

    def __init__(self, engine):
        nbr_flat, seg_ptr = engine.planner.full_structure()
        self.dst = np.asarray(nbr_flat, dtype=np.int64)
        self.seg = np.asarray(seg_ptr, dtype=np.int64)
        self.n = len(self.seg) - 1
        self.src = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.seg))

    def nbrs(self, v: int) -> np.ndarray:
        return self.dst[self.seg[v]:self.seg[v + 1]]


def _level_components(arr: _Arrays, core0, cnt, c):
    """Exact purecore components at level ``c`` by label propagation.

    Returns ``(sel, lab)``: the purecore membership mask and per-node
    component labels (min member id; -1 off-level).
    """
    sel = (core0 == c) & (cnt >= c + 1)
    lab = np.where(sel, np.arange(arr.n, dtype=np.int64), -1)
    em = sel[arr.src] & sel[arr.dst]
    a, b = arr.src[em], arr.dst[em]
    while True:
        new = lab.copy()
        np.minimum.at(new, b, lab[a])
        if np.array_equal(new, lab):
            break
        lab = new
    return sel, lab


def _peel(arr: _Arrays, core0, S: np.ndarray, c: int) -> np.ndarray:
    """Exact rise set of the level-``c`` candidate mask ``S``.

    Greatest fixpoint of: keep ``x`` in the risen set iff its support at
    ``c+1`` — neighbors with ``core0 >= c+1`` plus surviving co-risers —
    reaches ``c+1``.  ``base`` is optimism-independent, so it's computed
    once; the loop touches only the in-``S`` edges.
    """
    es = S[arr.src]
    base = np.zeros(arr.n, dtype=np.int64)
    np.add.at(base, arr.src[es],
              (core0[arr.dst[es]] >= c + 1).astype(np.int64))
    ie = es & S[arr.dst]
    a, b = arr.src[ie], arr.dst[ie]
    cur = S.copy()
    while True:
        inS = np.zeros(arr.n, dtype=np.int64)
        np.add.at(inS, a, cur[b].astype(np.int64))
        keep = cur & (base + inS >= c + 1)
        if np.array_equal(keep, cur):
            return cur
        cur = keep


def plan_batch(engine, core0, cnt, applied, cap=DEFAULT_GROUP_CAP,
               arr: _Arrays | None = None) -> BatchPlan:
    """Candidate sets + independent-group partition for one micro-batch.

    ``applied`` is ``[(kind, u, v), ...]`` of the structurally-applied
    (non-noop) updates; ``core0`` the round-start cores; ``cnt`` the exact
    Eq. 2 counts *after* the structural deltas (w.r.t. ``core0``);
    ``arr`` an optional pre-built adjacency snapshot of the same graph.
    """
    if arr is None:
        arr = _Arrays(engine)
    plan = BatchPlan()
    levels: dict = {}  # level -> (sel, lab), lazily built

    def level_cache(c):
        if c not in levels:
            levels[c] = _level_components(arr, core0, cnt, c)
        return levels[c]

    for i, (kind, u, v) in enumerate(applied):
        u, v = int(u), int(v)
        c = int(min(core0[u], core0[v]))
        if kind == "+":
            sel, lab = level_cache(c)
            roots = [e for e in (u, v) if sel[e]]
            if roots:
                labs = np.unique(lab[roots])
                cand = np.flatnonzero(sel & np.isin(lab, labs))
            else:
                cand = np.empty(0, dtype=np.int64)
            plan.updates.append(UpdateCand(
                kind="+", u=u, v=v, level=c, op=i, cand=cand,
                size=len(cand), heavy=len(cand) > cap))
        else:
            deficient = [e for e in (u, v)
                         if core0[e] == c and cnt[e] < core0[e]]
            if deficient:
                plan.updates.append(UpdateCand(
                    kind="-", u=u, v=v, level=c, op=i,
                    cand=np.empty(0, dtype=np.int64),
                    prefix_level=c, size=int((core0 <= c).sum())))
            else:
                plan.updates.append(UpdateCand(
                    kind="-", u=u, v=v, level=c, op=i,
                    cand=np.empty(0, dtype=np.int64)))

    _partition(plan)
    return plan


def _partition(plan: BatchPlan) -> None:
    """Union-find on candidate overlap: the independent groups (reported
    in :class:`~repro_torch.core.maintenance.MaintStats`; execution settles
    all groups in one masked fixpoint, so independence is observability,
    not a scheduling constraint)."""
    parent = list(range(len(plan.updates)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    owner: dict = {}  # node -> first update index claiming it
    for i, up in enumerate(plan.updates):
        for w in up.cand:
            j = owner.setdefault(int(w), i)
            if j != i:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri

    comps: dict = {}
    for i, up in enumerate(plan.updates):
        if up.size:
            comps.setdefault(find(i), []).append(up)
    plan.groups = list(comps.values())
    for g in plan.groups:
        _GROUP_SIZE.observe(sum(up.size for up in g))


def plan_risers(arr: _Arrays, core0, cnt, risers, cap=DEFAULT_GROUP_CAP
                ) -> BatchPlan:
    """Plan one saturation re-root round on the settled state.

    A +1 rise can enable further rises in exactly two places: the riser
    itself (now at a new level) and any neighbor whose own-level support
    the rise crossed (``core0[w] == new core of the riser``) — nothing
    else's Eq. 2 count moved.  Purecore components rooted at whichever of
    those pass the purecore test cover every remaining rise (the
    minimal-level witness of a missed rise passes the test and shares a
    component with such a node).  Usually empty — risers land with tight
    support."""
    plan = BatchPlan()
    rm = np.zeros(arr.n, dtype=bool)
    rm[risers] = True
    em = rm[arr.src]
    touched = arr.dst[em]
    touched = touched[core0[touched] == core0[arr.src[em]]]
    roots = np.unique(np.concatenate([risers, touched])) \
        if len(touched) else np.asarray(risers)
    for c in np.unique(core0[roots]):
        c = int(c)
        sel, lab = _level_components(arr, core0, cnt, c)
        rl = roots[(core0[roots] == c) & sel[roots]]
        if not len(rl):
            continue
        for l in np.unique(lab[rl]):
            cand = np.flatnonzero(lab == l)
            plan.updates.append(UpdateCand(
                kind="^", u=int(l), v=int(l), level=c, op=-1, cand=cand,
                size=len(cand), heavy=len(cand) > cap))
    _partition(plan)
    return plan


def _prep_state(arr: _Arrays, core0, cnt, updates):
    """Peeled warm bound + incrementally-exact cnt for the masked settle.

    Per level, the union of insert candidate sets is peeled to its exact
    rise set and the survivors warmed to ``level + 1``; cnt is then
    patched in one vectorized pass over the flat adjacency — no full
    Eq. 2 scan: a raised node ``y`` crosses the threshold of exactly its
    non-raised neighbors with ``core0`` in ``(core0[y], warm[y]]`` (+1
    each), and every raised node is recounted exactly against the warm
    values.  Level sets are disjoint, so the single-pass rules compose
    exactly.
    """
    warm = core0.copy()
    cnt = cnt.copy()
    mask = np.zeros(arr.n, dtype=bool)
    pmax = -1
    by_level: dict = {}
    for up in updates:
        if up.prefix_level >= 0:
            pmax = max(pmax, up.prefix_level)
        elif len(up.cand):
            S = by_level.get(up.level)
            if S is None:
                S = by_level[up.level] = np.zeros(arr.n, dtype=bool)
            S[up.cand] = True
    for c, S in by_level.items():
        risen = _peel(arr, core0, S, c)
        warm[risen] = c + 1
        mask |= risen
    if pmax >= 0:
        mask |= core0 <= pmax
    fresh = warm > core0
    if fresh.any():
        src, dst = arr.src, arr.dst
        pe = fresh[src] & ~fresh[dst] & (core0[dst] > core0[src]) \
            & (core0[dst] <= warm[src])
        np.add.at(cnt, dst[pe], 1)
        fe = fresh[src]
        s = src[fe]
        acc = np.zeros(arr.n, dtype=np.int64)
        np.add.at(acc, s, (warm[dst[fe]] >= warm[s]).astype(np.int64))
        cnt[fresh] = acc[fresh]
    return warm, cnt, mask


def _settle_round(maintainer, warm, cnt, mask, info):
    """One round's masked fixpoint from the peeled warm state.

    Returns ``(core, cnt, ok)`` — ``ok`` False when the feasibility
    certificate failed and the caller must escalate to the serial path.
    """
    engine = maintainer.engine
    backend = maintainer.backend

    from .resident import run_resident

    deficient = (cnt < warm) & (warm > 0) & mask
    resident = resident_on(engine, backend)
    if not deficient.any():
        core_f, cnt_f = warm, cnt
    elif resident:
        r = run_resident(engine, "semicore*", backend, core=warm,
                         cnt=cnt, settle_mask=mask,
                         superstep_chunk=maintainer.superstep_chunk)
        core_f, cnt_f = r.core, r.cnt
        info["iterations"] += r.iterations
        info["node_computations"] += r.node_computations
    else:
        # thread-free host settle (numpy, and the moral equivalent on a
        # device backend running without the resident working set): one
        # warm-start seq settle whose UpdateRange chases every cascade —
        # any node it touches outside the mask was drop-deficient, which
        # the masked path would have escalated on anyway
        d0 = np.flatnonzero(deficient)
        r = engine.semicore_star("seq", core=warm, cnt=cnt,
                                 vrange=(int(d0.min()), int(d0.max())),
                                 backend="numpy")
        core_f, cnt_f = r.core, r.cnt
        info["iterations"] += r.iterations
        info["node_computations"] += r.node_computations

    ok = bool(np.all(cnt_f >= core_f))
    return core_f, cnt_f, ok


def grouped_settle(maintainer, applied, cap=DEFAULT_GROUP_CAP):
    """The grouped maintenance settle for one structurally-applied batch.

    ``applied`` is the ordered ``[(kind, u, v), ...]`` list of non-noop
    updates; ``maintainer.cnt`` must already carry their structural deltas
    (Eq. 2 w.r.t. the pre-batch cores on the post-batch graph).  Settles in
    saturation rounds (see module docstring) and returns ``(core, cnt,
    summary, info)`` — ``summary`` a :class:`BatchPlan` aggregating every
    round's groups, ``info`` the settle counters (``iterations``,
    ``node_computations``, ``rounds``, ``reroots``, ``fallbacks``,
    ``escalated``, ``fallback``).
    """
    engine = maintainer.engine
    backend = maintainer.backend
    summary = BatchPlan()
    info = {"iterations": 0, "node_computations": 0, "rounds": 0,
            "reroots": 0, "fallbacks": 0, "escalated": 0,
            "fallback": False}
    total_ins = sum(1 for k, _, _ in applied if k == "+")

    def serial(core0):
        # warm = min(core0 + I, deg) with I the whole batch's insert count
        # is a sound bound from any round's start state (round cores only
        # grow, so round + I dominates the true post-batch cores)
        with _trace.span("maintenance.settle", cat="maintenance",
                         path="serial"):
            r = warm_settle(engine, core0, total_ins, backend,
                            superstep_chunk=maintainer.superstep_chunk)
        info["iterations"] += r.iterations
        info["node_computations"] += r.node_computations
        info["fallbacks"] += 1
        info["fallback"] = True
        return r.core, r.cnt

    with _trace.span("maintenance.plan", cat="maintenance"):
        arr = _Arrays(engine)  # the graph never changes during the settle
    risers = None  # round 1 plans from the updates; later from risers
    while True:
        info["rounds"] += 1
        core0 = maintainer.core
        with _trace.span("maintenance.plan", cat="maintenance"):
            if risers is None:
                plan = plan_batch(engine, core0, maintainer.cnt, applied,
                                  cap, arr=arr)
            else:
                plan = plan_risers(arr, core0, maintainer.cnt, risers, cap)
        if risers is not None:
            if not plan.updates:
                break
            info["reroots"] += len(plan.updates)
        summary.updates.extend(plan.updates)
        summary.groups.extend(plan.groups)

        if plan.heavy or info["rounds"] > _MAX_ROUNDS:
            # a candidate component exceeded the size threshold: the
            # exact-cnt prologue + SemiCore* warm settle covers everything
            for g in plan.groups:
                _GROUPS_FALLBACK.inc()
            core_f, cnt_f = serial(core0)
            maintainer.core, maintainer.cnt = core_f, cnt_f
            break
        for g in plan.groups:
            _GROUPS_SETTLED.inc()

        with _trace.span("maintenance.plan", cat="maintenance"):
            warm, cnt, mask = _prep_state(arr, core0, maintainer.cnt,
                                          plan.updates)
        if risers is not None and not np.any(warm > core0) \
                and not np.any((cnt < warm) & (warm > 0) & mask):
            break  # re-root peeled to nothing: already saturated
        with _trace.span("maintenance.settle", cat="maintenance",
                         path="masked"):
            core_f, cnt_f, ok = _settle_round(maintainer, warm, cnt, mask,
                                              info)
        if not ok:
            # feasibility certificate failed: a frozen node should have
            # dropped (an unforeseen leak).  The serial warm settle from
            # this round's pre-state is always exact.
            _ESCALATIONS.inc()
            info["escalated"] += 1
            core_f, cnt_f = serial(core0)
        maintainer.core, maintainer.cnt = core_f, cnt_f

        risers = np.flatnonzero(core_f > core0)
        if not len(risers):
            break

    _ROUNDS.observe(max(info["rounds"], 1))
    return maintainer.core, maintainer.cnt, summary, info
