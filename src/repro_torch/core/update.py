"""Typed edge-update vocabulary: the unit of work of maintenance.

The port's own copy of ``repro/core/update.py``.  One batch type —
:class:`UpdateBatch`, an order-preserving sequence of :class:`Insert` /
:class:`Delete` ops — is what ``CoreMaintainer.apply`` takes.  The
``(deletes, inserts)`` pair-of-lists view survives as properties (and
:meth:`UpdateBatch.from_pairs`): the settle algorithms are
order-insensitive *within* a coalesced batch, so deletes-then-inserts is a
canonical replay order, not information loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence, Tuple

__all__ = ["Insert", "Delete", "UpdateBatch"]


@dataclass(frozen=True)
class Insert:
    """Insert undirected edge (u, v)."""

    u: int
    v: int
    kind = "+"

    def edge(self) -> Tuple[int, int]:
        return (int(self.u), int(self.v))


@dataclass(frozen=True)
class Delete:
    """Delete undirected edge (u, v)."""

    u: int
    v: int
    kind = "-"

    def edge(self) -> Tuple[int, int]:
        return (int(self.u), int(self.v))


_OP_TYPES = {"+": Insert, "-": Delete}


class UpdateBatch:
    """An ordered, immutable micro-batch of edge updates.

    Iterating yields the ops in submission order.  ``deletes``/``inserts``
    project the legacy pair-of-lists view (each preserving relative order).
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Iterable = ()):  # ops: Insert | Delete
        ops = tuple(ops)
        for op in ops:
            if not isinstance(op, (Insert, Delete)):
                raise TypeError(
                    f"UpdateBatch takes Insert/Delete ops, got {op!r}")
        self.ops = ops

    # ------------------------------------------------------------ builders
    @classmethod
    def from_pairs(
        cls,
        deletes: Sequence[Tuple[int, int]] = (),
        inserts: Sequence[Tuple[int, int]] = (),
    ) -> "UpdateBatch":
        """Build from the legacy ``(deletes, inserts)`` pair of edge lists
        (deletes first — the canonical coalesced order)."""
        return cls(
            [Delete(int(u), int(v)) for u, v in deletes]
            + [Insert(int(u), int(v)) for u, v in inserts]
        )

    @classmethod
    def from_wire(cls, ops: Iterable[Sequence]) -> "UpdateBatch":
        """Decode the WAL wire form: ``[["+"|"-", u, v], ...]``."""
        return cls(_OP_TYPES[k](int(u), int(v)) for k, u, v in ops)

    def to_wire(self) -> list:
        """Encode for a WAL record: ``[[kind, u, v], ...]`` in op order."""
        return [[op.kind, int(op.u), int(op.v)] for op in self.ops]

    # ----------------------------------------------------------- legacy view
    @property
    def deletes(self) -> list:
        return [op.edge() for op in self.ops if isinstance(op, Delete)]

    @property
    def inserts(self) -> list:
        return [op.edge() for op in self.ops if isinstance(op, Insert)]

    # ------------------------------------------------------------- protocol
    def __iter__(self) -> Iterator:
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    def __bool__(self) -> bool:
        return bool(self.ops)

    def __eq__(self, other) -> bool:
        return isinstance(other, UpdateBatch) and self.ops == other.ops

    def __hash__(self) -> int:
        return hash(self.ops)

    def __repr__(self) -> str:
        nd, ni = len(self.deletes), len(self.inserts)
        return f"UpdateBatch({len(self.ops)} ops: {nd} del, {ni} ins)"
