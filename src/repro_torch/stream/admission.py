"""Batch admission for the streaming core service.

The port's own copy of ``repro/stream/admission.py``.

An edge-update stream arrives as ``("+"/"-", u, v)`` operations.  Before a
micro-batch touches the maintenance algorithms it is *admitted*:

* operations are normalized (self loops dropped, endpoints canonicalized to
  ``u < v``),
* per edge, only the **last** operation in stream order survives — an
  insert+delete pair inside one batch cancels to whatever the final state
  asks for, duplicates collapse (the maintenance pass later resolves the
  surviving op against the actual graph, so "insert an edge that already
  exists" degrades to a counted no-op, never an error), and
* deletions are ordered before insertions.  Deletions only lower cores
  (SemiDelete* settles them with cheap SemiCore* passes); applying them
  first keeps every intermediate ``core`` an upper bound of the final
  decomposition and avoids paying SemiInsert* expansion for nodes a later
  delete would pull back down.

After coalescing, the surviving operations touch distinct edges, so the
delete-first reordering cannot change the batch's net effect.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.update import UpdateBatch

__all__ = ["AdmittedBatch", "admit_batch"]

INSERT = "+"
DELETE = "-"


@dataclass
class AdmittedBatch:
    """A coalesced, reordered micro-batch ready for ``CoreMaintainer.apply``
    (via the :attr:`batch` projection)."""

    deletes: list = field(default_factory=list)  # [(u, v)], u < v
    inserts: list = field(default_factory=list)  # [(u, v)], u < v
    num_requested: int = 0  # raw ops in the incoming batch
    num_dropped: int = 0  # self loops / malformed ops
    num_coalesced: int = 0  # ops superseded by a later op on the same edge

    @property
    def num_admitted(self) -> int:
        return len(self.deletes) + len(self.inserts)

    @property
    def batch(self) -> UpdateBatch:
        """The admitted ops as a typed :class:`UpdateBatch` (deletes first —
        the coalesced order admission decided on)."""
        return UpdateBatch.from_pairs(self.deletes, self.inserts)


def admit_batch(ops, n: int | None = None) -> AdmittedBatch:
    """Normalize, coalesce (last op per edge wins) and reorder a batch.

    With ``n`` given, ops naming nodes outside ``[0, n)`` are dropped (and
    counted) — the node table is fixed-size O(n) state, so an out-of-range
    id can never be applied and must not reach the update buffer.
    """
    last: dict[tuple[int, int], str] = {}
    requested = dropped = 0
    for op in ops:
        requested += 1
        try:
            kind, u, v = op
            u, v = int(u), int(v)
        except (TypeError, ValueError):
            dropped += 1
            continue
        if u == v or kind not in (INSERT, DELETE):
            dropped += 1
            continue
        if n is not None and not (0 <= u < n and 0 <= v < n):
            dropped += 1
            continue
        if u > v:
            u, v = v, u
        last[(u, v)] = kind  # first-seen key order is kept: deterministic
    batch = AdmittedBatch(
        num_requested=requested,
        num_dropped=dropped,
        num_coalesced=requested - dropped - len(last),
    )
    for edge, kind in last.items():
        (batch.deletes if kind == DELETE else batch.inserts).append(edge)
    return batch
