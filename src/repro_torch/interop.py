"""Carry graphs and decomposition state into the port from plain fields.

Objects of another implementation (the JAX package's ``CSRGraph``,
``BufferedGraph`` and ``DecompResult`` among them) are read only through
their numpy fields, by attribute, never by importing that implementation:

* :func:`csr_from` — any object with ``indptr``/``adj`` arrays;
* :func:`buffered_from` — any object with a ``base`` CSR and the buffered
  edge deltas (``_ins``/``_del`` endpoint sets, ``_deg_delta``, ``version``,
  ``capacity``);
* :func:`warm_state` — a ``(core, cnt)`` pair, or any object with ``core``
  and ``cnt`` arrays.

Each returns the port's own objects (or int64 numpy arrays), so both
implementations compute on the same inputs.
"""
from __future__ import annotations

import numpy as np

from .graph.storage import CSRGraph
from .graph.updates import BufferedGraph

__all__ = ["csr_from", "buffered_from", "warm_state"]


def csr_from(graph) -> CSRGraph:
    """The port's CSRGraph over copies of ``graph.indptr`` / ``graph.adj``."""
    return CSRGraph(indptr=np.array(graph.indptr, dtype=np.int64),
                    adj=np.array(graph.adj, dtype=np.int32))


def buffered_from(buffered) -> BufferedGraph:
    """The port's BufferedGraph holding the same base CSR and the same
    buffered edge deltas (and structural version) as ``buffered``."""
    out = BufferedGraph(csr_from(buffered.base),
                        buffer_capacity=buffered.capacity)
    out._ins = {int(u): {int(v) for v in vs} for u, vs in buffered._ins.items()}
    out._del = {int(u): {int(v) for v in vs} for u, vs in buffered._del.items()}
    out._size = int(buffered._size)
    out._deg_delta = np.array(buffered._deg_delta, dtype=np.int64)
    out.version = int(buffered.version)
    return out


def warm_state(core, cnt=None) -> tuple:
    """``(core, cnt)`` as int64 numpy copies; ``core`` may instead be an
    object with ``core``/``cnt`` arrays (a decomposition result)."""
    if cnt is None and hasattr(core, "core"):
        core, cnt = core.core, core.cnt
    return (np.array(core, dtype=np.int64),
            None if cnt is None else np.array(cnt, dtype=np.int64))
