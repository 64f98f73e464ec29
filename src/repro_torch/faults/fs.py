"""The fault-injection surface and the power-loss simulator.

The port's own copy of ``repro/faults/fs.py``.  Code with filesystem side
effects routes them through the hooks here (``graph/storage.BlockReader``
calls :func:`on_op` before each block fill):

* :func:`on_op` — read-ish operations (block fills, snapshot loads): may
  raise a transient :class:`FaultInjected` or inject latency;
* :func:`write` — byte writes: may raise before writing (``io_error``),
  land only a prefix then raise (``torn_write`` / ``enospc``), silently
  flip one bit (``bit_flip``), or delay;
* :func:`fsync` / :func:`fsync_dir` — may lie (return success without
  syncing, and without marking the data durable in the power-loss
  journal) or raise;
* :func:`replace` — atomic renames, journaled so a later simulated power
  loss can undo a rename whose directory entry was never fsynced.

With no plan installed (:data:`_ACTIVE` is ``None``) every hook is a single
``is None`` check plus the real OS call.

The **power-loss simulator** backs the lying-fsync test mode: when the
active plan sets ``track_durability``, writes, fsyncs and renames are
journaled and :func:`simulate_power_loss` reverts exactly the state no
honoured fsync covered: un-synced file suffixes are truncated away and
un-synced directory entries (renames) are undone.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

from .plan import FaultInjected, FaultPlan

__all__ = [
    "inject", "active_plan", "on_op", "write", "fsync", "fsync_dir",
    "replace", "flip_bit", "simulate_power_loss",
]

_ACTIVE: FaultPlan | None = None
_TRACKER: "_DurabilityTracker | None" = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` as the process-wide fault schedule for the block."""
    global _ACTIVE, _TRACKER
    prev, prev_tracker = _ACTIVE, _TRACKER
    _ACTIVE = plan
    _TRACKER = _DurabilityTracker() if plan.track_durability else None
    try:
        yield plan
    finally:
        _ACTIVE, _TRACKER = prev, prev_tracker


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def _decide(op: str):
    return _ACTIVE.decide(op) if _ACTIVE is not None else None


# ------------------------------------------------------------------- hooks
def on_op(op: str) -> None:
    """Hook for read-ish operations: may raise transiently or add latency."""
    d = _decide(op)
    if d is None:
        return
    kind, arg, index = d
    if kind == "latency":
        time.sleep(arg)
    elif kind in ("io_error", "enospc"):
        raise FaultInjected(op, kind, index)
    # write-only kinds scheduled against a read op degrade to io_error so a
    # chaos schedule can use one rate table across mixed op patterns
    elif kind in ("torn_write", "bit_flip"):
        raise FaultInjected(op, "io_error", index)


def write(f, op: str, data: bytes, path: str | None = None) -> None:
    """Write ``data`` to file object ``f``, subject to the active plan.

    ``io_error`` raises before anything lands; ``torn_write``/``enospc``
    land ``arg``-fraction of the bytes then raise; ``bit_flip`` lands all
    bytes with one deterministically chosen bit inverted (silent — only a
    checksum can catch it); ``latency`` sleeps first.  All landed bytes are
    journaled as *not yet durable* when power-loss tracking is armed.
    """
    d = _decide(op)
    if d is None:
        _note_write(f, path, data)
        f.write(data)
        return
    kind, arg, index = d
    if kind == "io_error":
        raise FaultInjected(op, kind, index)
    if kind == "latency":
        time.sleep(arg)
    elif kind in ("torn_write", "enospc"):
        torn = data[: max(0, int(len(data) * arg))]
        _note_write(f, path, torn)
        f.write(torn)
        f.flush()
        raise FaultInjected(op, kind, index)
    elif kind == "bit_flip" and len(data) > 1:
        # never flip the trailing record delimiter: bit rot inside a record
        # is the case checksums exist for (a lost delimiter is a torn tail,
        # which framing already handles)
        pos = _ACTIVE._rng.randrange((len(data) - 1) * 8)
        b = bytearray(data)
        b[pos // 8] ^= 1 << (pos % 8)
        data = bytes(b)
    _note_write(f, path, data)
    f.write(data)


def fsync(f, op: str, path: str | None = None) -> bool:
    """fsync ``f`` unless the plan says the drive lies.  Returns True when
    the sync actually happened (and marks the file durable in the
    power-loss journal)."""
    d = _decide(op)
    if d is not None:
        kind, _arg, index = d
        if kind == "lying_fsync":
            return False  # reported success, nothing durable
        if kind in ("io_error", "enospc"):
            raise FaultInjected(op, kind, index)
    os.fsync(f.fileno())
    if _TRACKER is not None and path is not None:
        _TRACKER.mark_file_durable(path)
    return True


def fsync_dir(path: str, op: str = "fsync_dir") -> bool:
    """fsync a *directory* so renamed/created entries survive power loss.

    ``os.replace`` makes a rename atomic but not durable: the new directory
    entry lives in the page cache until the directory inode is synced.
    No-op (returns False) on platforms that cannot open directories;
    honours lying-fsync faults.
    """
    d = _decide(op)
    if d is not None:
        kind, _arg, index = d
        if kind == "lying_fsync":
            return False
        if kind in ("io_error", "enospc"):
            raise FaultInjected(op, kind, index)
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return False  # platform without directory fds: nothing to do
    try:
        os.fsync(fd)
    except OSError:
        return False
    finally:
        os.close(fd)
    if _TRACKER is not None:
        _TRACKER.mark_dir_durable(path)
    return True


def replace(src: str, dst: str, op: str = "replace") -> None:
    """``os.replace`` with fault + durability-journal hooks."""
    d = _decide(op)
    if d is not None:
        kind, arg, index = d
        if kind in ("io_error", "enospc"):
            raise FaultInjected(op, kind, index)
        if kind == "latency":
            time.sleep(arg)
    if _TRACKER is not None:
        _TRACKER.note_replace(src, dst)
    os.replace(src, dst)


def _note_write(f, path: str | None, data: bytes) -> None:
    if _TRACKER is not None and path is not None and data:
        _TRACKER.note_write(path, f)


# ------------------------------------------------- power-loss simulation
class _DurabilityTracker:
    """Journal of what would survive a power cut right now.

    Files: the durable prefix length (baseline = size when first seen;
    advanced only by an *honored* fsync).  Directories: a stack of undo
    actions for renames whose directory entry was never dir-fsynced.
    """

    def __init__(self):
        self.file_durable: dict[str, int] = {}
        self.dir_pending: dict[str, list] = {}

    # -- files -------------------------------------------------------------
    def note_write(self, path: str, f) -> None:
        path = os.path.abspath(path)
        if path not in self.file_durable:
            try:
                f.flush()
            except (OSError, ValueError):
                pass
            size = os.path.getsize(path) if os.path.exists(path) else 0
            self.file_durable[path] = size

    def mark_file_durable(self, path: str) -> None:
        path = os.path.abspath(path)
        if os.path.exists(path):
            self.file_durable[path] = os.path.getsize(path)

    # -- directory entries ---------------------------------------------------
    def note_replace(self, src: str, dst: str) -> None:
        dst = os.path.abspath(dst)
        parent = os.path.dirname(dst)
        shadow = None
        if os.path.exists(dst):  # preserve the pre-rename target for undo
            shadow = dst + ".preloss_shadow"
            if os.path.isdir(dst):
                if os.path.exists(shadow):
                    shutil.rmtree(shadow)
                shutil.copytree(dst, shadow)
            else:
                shutil.copy2(dst, shadow)
        self.dir_pending.setdefault(parent, []).append((dst, shadow))
        # the rename rewrites dst wholesale: byte-level tracking is stale
        self.file_durable.pop(dst, None)

    def mark_dir_durable(self, path: str) -> None:
        for dst, shadow in self.dir_pending.pop(os.path.abspath(path), []):
            if shadow and os.path.exists(shadow):
                (shutil.rmtree if os.path.isdir(shadow) else os.remove)(shadow)

    # -- the cut -----------------------------------------------------------
    def power_loss(self) -> None:
        for path, durable in self.file_durable.items():
            if os.path.exists(path) and os.path.getsize(path) > durable:
                with open(path, "rb+") as f:
                    f.truncate(durable)
        for undos in self.dir_pending.values():
            for dst, shadow in reversed(undos):
                if os.path.exists(dst):  # the entry never hit the disk
                    (shutil.rmtree if os.path.isdir(dst) else os.remove)(dst)
                if shadow and os.path.exists(shadow):
                    os.replace(shadow, dst)
        self.file_durable.clear()
        self.dir_pending.clear()


def simulate_power_loss() -> None:
    """Revert every un-fsynced effect journaled since ``inject()`` armed the
    tracker (requires a plan with ``track_durability=True``)."""
    if _TRACKER is None:
        raise RuntimeError(
            "power-loss simulation needs an active FaultPlan with "
            "track_durability=True")
    _TRACKER.power_loss()


# ----------------------------------------------------------- test utility
def flip_bit(path: str, byte_index: int, bit: int = 0) -> None:
    """Flip one bit of a file in place — at-rest bit rot for tests.

    Negative ``byte_index`` counts from the end of the file.
    """
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if byte_index < 0:
            byte_index += size
        if not (0 <= byte_index < size):
            raise ValueError(f"byte {byte_index} outside file of {size} bytes")
        f.seek(byte_index)
        b = f.read(1)[0] ^ (1 << (bit % 8))
        f.seek(byte_index)
        f.write(bytes([b]))
