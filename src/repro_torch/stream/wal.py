"""Durability for the streaming core service: write-ahead log + snapshots.

The port's own copy of ``repro/stream/wal.py``: the same WAL frames, the
same snapshot layout and the same ``manifest.json``, byte for byte, so
either package recovers from the other's files.  The manifest's file
checksums run through the lane-parallel :func:`.integrity.crc32c`.

The service's durable state is tiny — the O(n) node arrays (``core``,
``cnt``) plus the graph itself — which the paper's semi-external contract
already forces through a disk-resident edge table.  Crash recovery therefore
needs only:

* a **write-ahead log**: one record per admitted micro-batch, appended
  (and optionally fsynced) *before* the batch is applied.  A crash mid-append
  leaves a torn final record, which replay ignores — that batch was never
  acknowledged;
* a **snapshot store**: periodic atomic dumps of (epoch, CSR graph, core,
  cnt).  Snapshots are written to a temp directory and published with an
  atomic rename (plus a directory fsync) so a crash never exposes a
  half-written snapshot.

Recovery = latest snapshot + structural replay of the WAL tail + a warm
SemiCore* settle (see service.recover; for the upper-bound
argument).

**Integrity**: every record appended by this version is
framed ``c1 <len> <crc32c> <payload>\\n`` (:mod:`.integrity`),
and snapshots carry a checksummed ``manifest.json``.  Legacy unframed JSON
lines still replay.  A corrupt *final* record is handled like a torn tail
(truncated / skipped — the batch was never acknowledged); a corrupt
*interior* record raises a typed :class:`CorruptionError` (legacy lines keep
raising ``json.JSONDecodeError``) which the replica converts into a
snapshot catch-up and the writer converts into recover-from-snapshot.
Rotation doubles as log *repair*: unparseable records are dropped (and
counted), so after any snapshot+rotation the live log is clean again.
Filesystem side effects route through :mod:`repro_torch.faults.fs`, which is a
no-op unless a test installs a :class:`~repro_torch.faults.FaultPlan`.

The WAL is also the **replication stream**: read replicas
tail it with :class:`WalTailer` — a stat/offset cursor that consumes only
complete (newline-terminated) records, tolerates the writer's in-flight
tail, and re-seeks after a rotation.  Rotation (``rotate(after_epoch)``,
invoked on snapshot publish) atomically drops records a published snapshot
supersedes, so the log's size tracks the snapshot interval rather than the
stream's lifetime.

Memory discipline: replay, torn-tail truncation, tailing and rotation are
all O(record) — the log is streamed line-by-line (the torn tail is found by
scanning *backwards* in bounded chunks), never slurped, so a multi-GB WAL
recovers in constant memory.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings

import numpy as np

from ..core.update import UpdateBatch
from ..faults import fs as _faults
from ..graph.storage import CSRGraph
from ..obs import metrics as _metrics, trace as _trace
from .integrity import CorruptionError, crc32c, frame_record, is_framed, unframe

__all__ = ["WriteAheadLog", "SnapshotStore", "WalTailer", "WalGap",
           "CorruptionError"]

_WAL_APPENDS = _metrics.counter(
    "repro_wal_appends_total", "WAL records appended").labels()
_WAL_BYTES = _metrics.counter(
    "repro_wal_bytes_total", "Bytes written to the WAL (incl. newline)").labels()
_WAL_FSYNCS = _metrics.counter(
    "repro_wal_fsyncs_total", "fsync() calls issued by the WAL").labels()
_WAL_APPEND_SECONDS = _metrics.histogram(
    "repro_wal_append_seconds", "WAL append latency (write+flush+fsync)")
_WAL_ROTATIONS = _metrics.counter(
    "repro_wal_rotations_total", "WAL rotations (snapshot-superseded prefix "
    "dropped atomically)").labels()
_WAL_ROTATED_RECORDS = _metrics.counter(
    "repro_wal_rotated_records_total",
    "WAL records dropped by rotation (epoch <= snapshot epoch)").labels()
_WAL_REPAIRED_RECORDS = _metrics.counter(
    "repro_wal_repaired_records_total",
    "Unparseable WAL records dropped by rotation (log repair)").labels()
_SNAP_WRITES = _metrics.counter(
    "repro_snapshot_writes_total", "Snapshots published atomically").labels()
_SNAP_SECONDS = _metrics.histogram(
    "repro_snapshot_seconds", "Snapshot save latency (write + rename + GC)")
_SNAP_FALLBACKS = _metrics.counter(
    "repro_snapshot_fallbacks_total",
    "Snapshot loads that fell back past a corrupt/unreadable snapshot").labels()

#: backwards-scan chunk for torn-tail detection / tip peeking (bytes).
_SCAN_CHUNK = 1 << 16


class WalGap(RuntimeError):
    """A tailer fell behind a rotation: the WAL no longer contains the next
    record it needs (first surviving epoch > last applied + 1).  The tailer's
    owner must catch up through the snapshot store instead."""


def _find_tail_start(f, size: int, chunk: int = _SCAN_CHUNK) -> int:
    """Byte offset where the final (possibly torn) line begins.

    Scans *backwards* in bounded chunks from ``size`` for the last newline
    strictly before the final byte, so memory stays O(chunk) no matter how
    large the log is.  ``size`` must not include a trailing newline byte at
    ``size-1`` (callers strip it first when they want the last *complete*
    line).
    """
    pos = size
    while pos > 0:
        lo = max(0, pos - chunk)
        f.seek(lo)
        buf = f.read(pos - lo)
        nl = buf.rfind(b"\n")
        if nl != -1:
            return lo + nl + 1
        pos = lo
    return 0


def _parse_record(raw: bytes, *, path: str | None = None,
                  offset: int | None = None) -> dict:
    """Parse one stripped, non-empty WAL line into its record dict.

    Framed (``c1 ...``) lines are checksum-verified and raise
    :class:`CorruptionError` on any mismatch; legacy unframed JSON lines
    parse as before and keep raising ``json.JSONDecodeError`` on damage
    (pre-framing callers depend on that type).
    """
    if is_framed(raw):
        payload = unframe(raw, path=path, offset=offset)
        try:
            return json.loads(payload.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            # the CRC matched but the payload is garbage: a writer bug or a
            # collision — either way typed corruption, not a parse quirk.
            raise CorruptionError(f"framed payload is not valid JSON: {e}",
                                  path=path, offset=offset) from None
    return json.loads(raw.decode("utf-8", errors="replace"))


def _record_batch(rec: dict) -> UpdateBatch:
    """Decode a WAL record dict into its :class:`UpdateBatch`.

    Current records carry the typed op vocabulary (``"ops"``: ordered
    ``[kind, u, v]`` triples).  Legacy ``"del"``/``"ins"`` pair records
    decode as deletes-then-inserts — the canonical coalesced order the
    writer applied them in, so replay stays bit-identical.
    """
    if "ops" in rec:
        return UpdateBatch.from_wire(rec["ops"])
    return UpdateBatch.from_pairs(rec.get("del", ()), rec.get("ins", ()))


class WriteAheadLog:
    """Append-only log of admitted micro-batches, keyed by epoch.

    Records are checksum-framed (see module docstring); appends self-heal:
    if the write or fsync fails (real or injected), the file is rolled back
    to the pre-append offset so a caller's retry never lands after a torn
    fragment.
    """

    ROTATE_TMP_SUFFIX = ".rotate_tmp"

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a crash mid-rotation leaves the filtered temp file behind with the
        # original log intact (os.replace never ran): discard the temp.
        tmp = path + self.ROTATE_TMP_SUFFIX
        if os.path.exists(tmp):
            os.remove(tmp)
        self._truncate_torn_tail(path)
        self._f = open(path, "ab")
        self.appends = 0
        self.rotations = 0
        self.repaired = 0

    @staticmethod
    def _truncate_torn_tail(path: str) -> None:
        """Drop a crash-torn final line so new appends never concatenate
        onto it (a merged line would corrupt the *next* recovery).  A final
        *complete* framed record that fails its checksum is dropped the same
        way — it was never acknowledged-and-applied by a clean writer, and
        leaving it would turn into interior corruption at the next append.

        The last newline is found by scanning backwards in bounded chunks —
        peak memory is O(chunk), not O(log)."""
        if not os.path.exists(path):
            return
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            f.seek(size - 1)
            if f.read(1) != b"\n":
                size = _find_tail_start(f, size - 1)
                f.truncate(size)
            while size > 0:
                start = _find_tail_start(f, size - 1)
                f.seek(start)
                line = f.read(size - start).strip()
                if not line or not is_framed(line):
                    return  # legacy tail records keep the replay-time policy
                try:
                    unframe(line)
                    return  # healthy framed tail: nothing to heal
                except CorruptionError:
                    size = start
                    f.truncate(size)

    def append(self, epoch: int, batch, inserts=None) -> None:
        """Append one admitted micro-batch as a typed op record.

        ``batch`` is an :class:`UpdateBatch` (any iterable of
        ``Insert``/``Delete`` ops is promoted).  The historical
        ``append(epoch, deletes, inserts)`` pair form still works as a
        deprecated shim — it encodes deletes-then-inserts, which is the
        order the writer applied them in, so nothing changes on replay.
        """
        if inserts is not None:
            warnings.warn(
                "WriteAheadLog.append(epoch, deletes, inserts) is "
                "deprecated; pass an UpdateBatch",
                DeprecationWarning, stacklevel=2)
            batch = UpdateBatch.from_pairs(batch, inserts)
        elif not isinstance(batch, UpdateBatch):
            batch = UpdateBatch(tuple(batch))
        rec = {"epoch": int(epoch), "ops": batch.to_wire()}
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        line = frame_record(payload)
        t0 = time.perf_counter()
        with _trace.span("wal.append", cat="stream", epoch=int(epoch),
                         bytes=len(line), fsync=self.fsync):
            self._f.seek(0, os.SEEK_END)
            start = self._f.tell()
            try:
                _faults.write(self._f, "wal.append", line, path=self.path)
                self._f.flush()
                if self.fsync:
                    _faults.fsync(self._f, "wal.fsync", path=self.path)
                    _WAL_FSYNCS.inc()
            except Exception:
                # self-heal: a failed append must leave no torn fragment for
                # the retry to concatenate onto.
                try:
                    self._f.flush()
                except OSError:
                    pass
                try:
                    os.ftruncate(self._f.fileno(), start)
                    self._f.seek(0, os.SEEK_END)
                except OSError:
                    pass
                raise
        _WAL_APPEND_SECONDS.observe(time.perf_counter() - t0)
        _WAL_APPENDS.inc()
        _WAL_BYTES.inc(len(line))
        self.appends += 1

    def rotate(self, after_epoch: int) -> int:
        """Atomically drop records with ``epoch <= after_epoch``.

        Invoked on snapshot publish: a record at or below the snapshot epoch
        is superseded (recovery and replicas bootstrap from the snapshot) and
        only bloats replay.  The surviving tail is *streamed* to a temp file
        and published with an atomic rename — a crash at any point leaves
        either the old complete log or the new complete log, never a
        half-rotated one.  Tailers notice the inode change and re-seek
        (:class:`WalTailer`).

        Rotation is also the log's *repair* path: records that fail their
        checksum (or do not parse at all) are dropped and counted in
        ``repaired`` — the snapshot that triggered this rotation supersedes
        them, so dropping is safe and unwedges any replica stuck behind the
        corruption.  Surviving legacy records are re-framed.  Returns the
        number of superseded records dropped.
        """
        self._f.flush()
        tmp = self.path + self.ROTATE_TMP_SUFFIX
        dropped = 0
        repaired = 0
        with _trace.span("wal.rotate", cat="stream",
                         after_epoch=int(after_epoch)):
            with open(self.path, "rb") as src, open(tmp, "wb") as out:
                offset = 0
                while True:
                    line = src.readline()
                    if not line:
                        break
                    next_offset = src.tell()
                    stripped = line.strip()
                    if stripped:
                        try:
                            rec = _parse_record(stripped, path=self.path,
                                                offset=offset)
                        except (CorruptionError, json.JSONDecodeError):
                            repaired += 1
                            rec = None
                        if rec is not None:
                            if rec["epoch"] <= after_epoch:
                                dropped += 1
                            else:
                                body = json.dumps(
                                    rec, separators=(",", ":")).encode("utf-8")
                                out.write(frame_record(body))
                    offset = next_offset
                out.flush()
                if self.fsync:
                    _faults.fsync(out, "wal.rotate.fsync", path=tmp)
            _faults.replace(tmp, self.path, op="wal.rotate.replace")
            # durability satellite: the rename is atomic but its directory
            # entry is not durable until the directory inode is synced.
            _faults.fsync_dir(
                os.path.dirname(os.path.abspath(self.path)), "wal.dirsync")
            # the open append handle points at the replaced (now anonymous)
            # inode — reopen so later appends land in the published log.
            self._f.close()
            self._f = open(self.path, "ab")
        self.rotations += 1
        self.repaired += repaired
        _WAL_ROTATIONS.inc()
        _WAL_ROTATED_RECORDS.inc(dropped)
        if repaired:
            _WAL_REPAIRED_RECORDS.inc(repaired)
        return dropped

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay(path: str, after_epoch: int = -1):
        """Yield ``(epoch, UpdateBatch)`` for batches past ``after_epoch``.

        Both record generations decode — typed ``"ops"`` records in op
        order, legacy ``"del"``/``"ins"`` records as deletes-then-inserts
        (see :func:`_record_batch`).

        Streams the log line-by-line (O(record) memory, never ``readlines``).
        A torn or checksum-corrupt *final* record is skipped (that batch was
        never acknowledged); damage anywhere else is real corruption and
        raises — :class:`CorruptionError` with the byte offset for framed
        records, ``json.JSONDecodeError`` for legacy lines.
        """
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            offset = 0
            while True:
                line = f.readline()
                if not line:
                    return
                start = offset
                offset = f.tell()
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = _parse_record(stripped, path=path, offset=start)
                except (CorruptionError, json.JSONDecodeError):
                    # only a *final* bad record is a torn/corrupt tail (the
                    # batch was never acknowledged); anything after it means
                    # mid-log corruption, which must not be silently skipped.
                    if f.read(_SCAN_CHUNK).strip():
                        raise
                    return
                if rec["epoch"] <= after_epoch:
                    continue
                yield rec["epoch"], _record_batch(rec)

    @staticmethod
    def tip_epoch(path: str):
        """Epoch of the last *complete, intact* record, or ``None``.

        Reads only the final line(s) (backwards chunk scan + one parse), so
        a replica's ``lag()`` probe costs O(record) regardless of log size.
        One corrupt final record is stepped over (torn-tail policy); a
        second bad record in a row is interior corruption and raises.
        """
        if not os.path.exists(path):
            return None
        corrupt_skipped = False
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            end = f.tell()
            if end:
                f.seek(end - 1)
                if f.read(1) != b"\n":  # torn final line: step back past it
                    end = _find_tail_start(f, end - 1)
            while end > 0:
                # ``end`` sits just past a newline: the line ending there is
                # complete.  Blank lines are skipped by scanning further back.
                start = _find_tail_start(f, end - 1)
                f.seek(start)
                line = f.read(end - start).strip()
                if line:
                    try:
                        return int(_parse_record(
                            line, path=path, offset=start)["epoch"])
                    except (CorruptionError, json.JSONDecodeError):
                        if corrupt_skipped:
                            raise
                        corrupt_skipped = True
                end = start
        return None


class WalTailer:
    """Incremental, restartable WAL cursor for read replicas.

    Resumes from a byte offset, consumes only **complete** records (a final
    line without its newline is the writer's in-flight append — or a torn
    crash remnant — and is left for the next poll), deduplicates by epoch,
    and re-verifies its position after a rotation: the atomic rename swaps
    the inode, so a changed inode (or a size below the cursor) forces a
    re-seek from the start, where the epoch filter drops already-applied
    records.

    If the first surviving record after a re-seek skips past
    ``last_epoch + 1``, the rotation outran this tailer and :class:`WalGap`
    is raised — the owner must catch up from the snapshot store.  A record
    that fails its checksum raises :class:`CorruptionError` *without
    advancing the cursor*: the owner bootstraps from a snapshot and the
    writer's next rotation repairs the log.
    """

    def __init__(self, path: str, after_epoch: int = -1):
        self.path = path
        self.offset = 0
        self.last_epoch = int(after_epoch)
        self._ino = None
        self.rotations_detected = 0
        self.records_read = 0

    def poll(self):
        """Yield ``(epoch, UpdateBatch)`` newly durable since last poll."""
        _faults.on_op("wal.poll")
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            st = os.fstat(f.fileno())  # fstat the fd: no stat/open race
            if self._ino is not None and (
                    st.st_ino != self._ino or st.st_size < self.offset):
                # rotated (new inode) or truncated under us: re-scan from the
                # start; the epoch filter below deduplicates.
                self.offset = 0
                self.rotations_detected += 1
            self._ino = st.st_ino
            f.seek(self.offset)
            while True:
                start = f.tell()
                line = f.readline()
                if not line or not line.endswith(b"\n"):
                    return  # in-flight / torn tail: not yet durable
                stripped = line.strip()
                if not stripped:
                    self.offset = f.tell()
                    continue
                try:
                    rec = _parse_record(stripped, path=self.path, offset=start)
                except CorruptionError:
                    raise  # cursor NOT advanced: re-polls see it until repair
                except json.JSONDecodeError as e:
                    raise CorruptionError(
                        f"unparseable legacy record: {e}",
                        path=self.path, offset=start) from None
                self.offset = f.tell()
                epoch = int(rec["epoch"])
                if epoch <= self.last_epoch:
                    continue
                # epochs are consecutive; a skip means rotation already
                # dropped records this tailer still needs.  (A cursor born
                # at after_epoch<0 tails from the log's own first record.)
                if self.last_epoch >= 0 and epoch > self.last_epoch + 1:
                    raise WalGap(
                        f"WAL at {self.path!r} resumes at epoch {epoch} but "
                        f"tailer last applied {self.last_epoch}: rotation "
                        "outran this replica; bootstrap from a snapshot"
                    )
                self.last_epoch = epoch
                self.records_read += 1
                yield epoch, _record_batch(rec)


class SnapshotStore:
    """Atomic (epoch, graph, core, cnt) snapshots with checksummed manifests.

    ``keep`` retains the newest N snapshots (default 1 = the historical
    behavior).  ``keep >= 2`` makes *recover-from-previous-snapshot* sound:
    when the latest snapshot is corrupt, ``latest()`` falls back to an older
    one, and the writer's rotation floor (``oldest_retained_epoch``) keeps
    the WAL records needed to roll forward from it.
    """

    PREFIX = "snap_"
    MANIFEST = "manifest.json"
    _CRC_CHUNK = 1 << 20

    def __init__(self, root: str, keep: int = 1):
        self.root = root
        self.keep = max(1, int(keep))
        self.fallbacks = 0
        os.makedirs(root, exist_ok=True)

    def _dir(self, epoch: int) -> str:
        return os.path.join(self.root, f"{self.PREFIX}{epoch:012d}")

    def _names(self):
        return sorted(
            n for n in os.listdir(self.root) if n.startswith(self.PREFIX))

    @classmethod
    def _file_crc(cls, path: str) -> tuple[int, int]:
        crc = 0
        size = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(cls._CRC_CHUNK)
                if not chunk:
                    return crc, size
                crc = crc32c(chunk, crc)
                size += len(chunk)

    def save(self, epoch: int, graph: CSRGraph, core: np.ndarray,
             cnt: np.ndarray) -> str:
        t0 = time.perf_counter()
        with _trace.span("snapshot.save", cat="stream", epoch=int(epoch),
                         nodes=int(graph.n), edges=int(graph.m)):
            _faults.on_op("snapshot.save")
            tmp = os.path.join(self.root, ".snap_tmp")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            graph.save(tmp)
            np.save(os.path.join(tmp, "core.npy"),
                    np.asarray(core, dtype=np.int64))
            np.save(os.path.join(tmp, "cnt.npy"),
                    np.asarray(cnt, dtype=np.int64))
            with open(os.path.join(tmp, "epoch.json"), "w") as f:
                json.dump({"epoch": int(epoch)}, f)
            self._write_manifest(tmp, epoch)
            # durability satellite: fsync every payload file, then the temp
            # directory, then publish, then the parent directory — without
            # the dir fsyncs a power loss can lose the published entry even
            # though every byte of content was synced.
            for name in os.listdir(tmp):
                p = os.path.join(tmp, name)
                with open(p, "rb") as f:
                    _faults.fsync(f, "snapshot.fsync", path=p)
            _faults.fsync_dir(tmp, "snapshot.dirsync")
            final = self._dir(epoch)
            if os.path.exists(final):
                shutil.rmtree(final)
            _faults.replace(tmp, final, op="snapshot.publish")
            _faults.fsync_dir(self.root, "snapshot.dirsync")
            for name in self._names()[:-self.keep]:  # keep-N GC
                full = os.path.join(self.root, name)
                if full != final:
                    shutil.rmtree(full)
        _SNAP_SECONDS.observe(time.perf_counter() - t0)
        _SNAP_WRITES.inc()
        return final

    def _write_manifest(self, d: str, epoch: int) -> None:
        files = {}
        for name in sorted(os.listdir(d)):
            if name == self.MANIFEST:
                continue
            crc, size = self._file_crc(os.path.join(d, name))
            files[name] = {"bytes": size, "crc32c": f"{crc:08x}"}
        body = {"version": 1, "epoch": int(epoch), "files": files}
        blob = json.dumps(body, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        manifest = dict(body, crc32c=f"{crc32c(blob):08x}")
        with open(os.path.join(d, self.MANIFEST), "w") as f:
            json.dump(manifest, f, sort_keys=True, separators=(",", ":"))

    def verify(self, d: str) -> None:
        """Integrity-check one snapshot directory against its manifest.

        Raises :class:`CorruptionError` on any mismatch.  Snapshots written
        before manifests existed (no ``manifest.json``) pass unverified.
        """
        mpath = os.path.join(d, self.MANIFEST)
        if not os.path.exists(mpath):
            return  # legacy snapshot: nothing to check against
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptionError(f"unreadable manifest: {e}",
                                  layer="snapshot", path=mpath) from None
        claimed = manifest.pop("crc32c", None)
        blob = json.dumps(manifest, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        if claimed != f"{crc32c(blob):08x}":
            raise CorruptionError("manifest checksum mismatch",
                                  layer="snapshot", path=mpath)
        for name, meta in manifest.get("files", {}).items():
            p = os.path.join(d, name)
            if not os.path.exists(p):
                raise CorruptionError(f"manifest lists missing file {name}",
                                      layer="snapshot", path=p)
            crc, size = self._file_crc(p)
            if size != meta["bytes"] or f"{crc:08x}" != meta["crc32c"]:
                raise CorruptionError(
                    f"file {name}: manifest says {meta['bytes']}B/"
                    f"{meta['crc32c']}, found {size}B/{crc:08x}",
                    layer="snapshot", path=p)

    def latest_epoch(self):
        """Epoch of the latest snapshot (directory-name parse only), or None.

        Cheap staleness floor for replicas: right after a rotation the WAL
        can be empty, but the snapshot that triggered it pins the writer's
        committed epoch from below.
        """
        names = self._names()
        return int(names[-1][len(self.PREFIX):]) if names else None

    def oldest_retained_epoch(self):
        """Epoch of the oldest retained snapshot, or None.

        The writer's WAL rotation floor: dropping records above this epoch
        would strand the fallback snapshots ``keep >= 2`` exists to provide.
        With the default ``keep=1`` this equals ``latest_epoch()``.
        """
        names = self._names()
        return int(names[0][len(self.PREFIX):]) if names else None

    def latest(self):
        """Return ``(epoch, graph, core, cnt)`` or None when no snapshot.

        Verifies the manifest before trusting a snapshot; a corrupt or
        unreadable snapshot falls back to the next-older one (counted in
        ``repro_snapshot_fallbacks_total``).  Raises :class:`CorruptionError`
        only when *every* retained snapshot fails.
        """
        _faults.on_op("snapshot.load")  # transient faults propagate: retryable
        names = self._names()
        last_err = None
        for i, name in enumerate(reversed(names)):
            d = os.path.join(self.root, name)
            try:
                self.verify(d)
                with open(os.path.join(d, "epoch.json")) as f:
                    epoch = json.load(f)["epoch"]
                graph = CSRGraph.load(d, mmap=False)
                core = np.load(os.path.join(d, "core.npy"))
                cnt = np.load(os.path.join(d, "cnt.npy"))
            except (CorruptionError, OSError, ValueError, KeyError,
                    json.JSONDecodeError) as e:
                last_err = e
                continue
            if i:
                self.fallbacks += 1
                _SNAP_FALLBACKS.inc(i)
            return epoch, graph, core, cnt
        if names:
            raise CorruptionError(
                f"all {len(names)} retained snapshots failed to load "
                f"(last error: {last_err})", layer="snapshot", path=self.root)
        return None
