"""Checksummed record framing for the WAL + snapshot manifest.

The port's own copy of ``repro/stream/integrity.py``: the same frames and
the same CRC32C values, so each package reads the other's logs and
snapshots.  Frame format (one line, still greppable text)::

    c1 <len> <crc32c-hex8> <payload>\\n

``c1`` is the version byte pair (``c`` = checksummed, ``1`` = format
version); ``len`` is the payload byte length in decimal; the CRC is CRC32C
(Castagnoli, poly 0x82F63B78 reflected) over the payload bytes only.
Legacy WAL lines start with ``{`` and are still replayed unframed.

Framing turns the two silent failure modes into *typed* ones: the length
catches torn/short writes that happen to end at a newline, the CRC catches
bit rot anywhere in the payload.  Both raise :class:`CorruptionError`
carrying the layer, path and byte offset.

Two ways to the same CRC32C: :func:`crc32c_plain` is the reference's
byte-at-a-time table loop, kept as the plain version; :func:`crc32c` runs
buffers of 16 KiB and more through numpy instead (a snapshot's files are
hundreds of MB).  It splits a buffer into many equal lanes, steps every
lane four bytes at a time (slicing-by-4 tables) with one vector operation
per step, and joins the lane CRCs pairwise up a tree with the GF(2)
shift-combine (zlib's ``crc32_combine``, on the Castagnoli polynomial).
"""
from __future__ import annotations

import numpy as np

__all__ = ["CorruptionError", "crc32c", "crc32c_plain", "crc32c_combine",
           "frame_record", "is_framed", "unframe", "FRAME_VERSION"]

FRAME_VERSION = b"c1"

# CRC32C (Castagnoli), reflected polynomial 0x82F63B78, table-driven.
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
_TABLE = tuple(_TABLE)


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` by the byte-at-a-time table loop (the plain
    version); pass a previous result as ``crc`` to stream."""
    c = crc ^ 0xFFFFFFFF
    for byte in data:
        c = _TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ----------------------------------------------------------- lanes on numpy
#: below this many bytes the plain loop is cheaper than setting up lanes.
_FAST_MIN = 1 << 14
#: lanes per step: the width of each vector operation.
_LANES = 1 << 15
#: bytes a lane takes at most per block (a multiple of 4), and at least.
_LANE_MAX = 1 << 11
_LANE_MIN = 1 << 8

# slicing-by-4: _SLICE[k][i] is the CRC step of byte i followed by k zero
# bytes, so four table reads advance a lane by one little-endian word.
_SLICE = [np.array(_TABLE, dtype=np.uint32)]
for _k in range(1, 4):
    _prev = _SLICE[-1]
    _SLICE.append((_prev >> np.uint32(8)) ^ _SLICE[0][_prev & np.uint32(0xFF)])


def _gf2_times(mat, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_mul(a, b) -> list:
    """The operator ``a`` after ``b`` (each a list of 32 column images)."""
    return [_gf2_times(a, col) for col in b]


def _one_zero_byte() -> list:
    # one zero bit: x -> x * x mod P (reflected); eight of them, one byte
    bit = [_POLY] + [1 << (i - 1) for i in range(1, 32)]
    two = _gf2_mul(bit, bit)
    four = _gf2_mul(two, two)
    return _gf2_mul(four, four)


_ZERO_BYTE = _one_zero_byte()
_SHIFT_CACHE: dict = {}


def _shift_op(nbytes: int) -> list:
    """The operator that appends ``nbytes`` zero bytes to a CRC register
    (``crc * x^(8 nbytes) mod P``), by binary powers of the one-byte op."""
    op = _SHIFT_CACHE.get(nbytes)
    if op is not None:
        return op
    result = [1 << i for i in range(32)]  # identity
    square = _ZERO_BYTE
    n = nbytes
    while n:
        if n & 1:
            result = _gf2_mul(square, result)
        n >>= 1
        if n:
            square = _gf2_mul(square, square)
    if len(_SHIFT_CACHE) < 256:
        _SHIFT_CACHE[nbytes] = result
    return result


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of ``A + B`` from ``crc1`` = CRC of A, ``crc2`` = CRC of B
    and ``len2`` = len(B) (zlib's ``crc32_combine``)."""
    if len2 <= 0:
        return crc1
    return _gf2_times(_shift_op(len2), crc1) ^ crc2


def _byte_tables(op) -> list:
    """``op`` as four 256-entry tables, one per byte of the register."""
    cols = np.array(op, dtype=np.uint32)
    bits = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)
    return [np.bitwise_xor.reduce(
        np.where(bits, cols[8 * b:8 * b + 8], np.uint32(0)), axis=1)
        .astype(np.uint32) for b in range(4)]


def _apply(tables, v: np.ndarray) -> np.ndarray:
    m = np.uint32(0xFF)
    return (tables[0][v & m] ^ tables[1][(v >> np.uint32(8)) & m]
            ^ tables[2][(v >> np.uint32(16)) & m] ^ tables[3][v >> np.uint32(24)])


def _block_crc(buf: np.ndarray, lanes: int, width: int) -> int:
    """CRC32C of ``buf`` (``lanes * width`` bytes, ``width % 4 == 0``)."""
    words = buf.view("<u4").reshape(lanes, width // 4)
    s0, s1, s2, s3 = _SLICE
    m = np.uint32(0xFF)
    c = np.full(lanes, 0xFFFFFFFF, dtype=np.uint32)
    t = np.empty(lanes, dtype=np.uint32)
    for j in range(width // 4):
        np.bitwise_xor(c, words[:, j], out=c)
        np.bitwise_and(c, m, out=t)
        acc = s3[t]
        np.right_shift(c, np.uint32(8), out=t)
        t &= m
        acc ^= s2[t]
        np.right_shift(c, np.uint32(16), out=t)
        t &= m
        acc ^= s1[t]
        np.right_shift(c, np.uint32(24), out=t)
        acc ^= s0[t]
        c = acc
    c ^= np.uint32(0xFFFFFFFF)
    span = width
    while len(c) > 1:  # join neighbouring lanes up a tree
        c = _apply(_byte_tables(_shift_op(span)), c[0::2]) ^ c[1::2]
        span *= 2
    return int(c[0])


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like); pass a previous result as ``crc``
    to stream.  Equal to :func:`crc32c_plain` for every input."""
    n = len(data)
    if n < _FAST_MIN:
        return crc32c_plain(data, crc)
    buf = np.frombuffer(data, dtype=np.uint8)
    pos = 0
    while n - pos >= _FAST_MIN:
        left = n - pos
        lanes = min(_LANES, 1 << ((left // _LANE_MIN).bit_length() - 1))
        width = min(left // lanes, _LANE_MAX) & ~3
        size = lanes * width
        crc = crc32c_combine(crc, _block_crc(buf[pos:pos + size], lanes,
                                             width), size)
        pos += size
    return crc32c_plain(buf[pos:].tobytes(), crc)


class CorruptionError(RuntimeError):
    """Persistent data failed an integrity check (checksum/length/structure).

    Unlike an ``IOError`` this is *not* transient — retrying the read
    returns the same corrupt bytes.  ``layer`` is ``"wal"`` or
    ``"snapshot"``; ``offset`` is the byte offset of the corrupt record
    when known (the writer uses it to truncate a corrupt WAL tail).
    """

    def __init__(self, detail: str, *, layer: str = "wal",
                 path: str | None = None, offset: int | None = None):
        where = f" in {path}" if path else ""
        at = f" at byte {offset}" if offset is not None else ""
        super().__init__(f"{layer} corruption{where}{at}: {detail}")
        self.layer = layer
        self.path = path
        self.offset = offset
        self.detail = detail


def frame_record(payload: bytes) -> bytes:
    """Wrap one payload into a ``c1``-framed line (includes the newline)."""
    return b"%s %d %08x %s\n" % (
        FRAME_VERSION, len(payload), crc32c(payload), payload)


def is_framed(line: bytes) -> bool:
    """True when ``line`` claims to be a versioned checksummed frame."""
    return line.startswith(FRAME_VERSION + b" ")


def unframe(line: bytes, *, path: str | None = None,
            offset: int | None = None) -> bytes:
    """Validate one framed line (sans trailing newline ok) -> payload bytes.

    Raises :class:`CorruptionError` on any mismatch: bad header structure,
    length mismatch (torn write), or CRC mismatch (bit rot).
    """
    line = line.rstrip(b"\n")
    parts = line.split(b" ", 3)
    if len(parts) != 4 or parts[0] != FRAME_VERSION:
        raise CorruptionError("malformed frame header",
                              path=path, offset=offset)
    try:
        length = int(parts[1])
        expect = int(parts[2], 16)
    except ValueError:
        raise CorruptionError("unparseable frame length/crc",
                              path=path, offset=offset) from None
    payload = parts[3]
    if len(payload) != length:
        raise CorruptionError(
            f"length mismatch: frame says {length}, got {len(payload)} "
            "(torn write?)", path=path, offset=offset)
    actual = crc32c(payload)
    if actual != expect:
        raise CorruptionError(
            f"crc mismatch: frame says {expect:08x}, payload is {actual:08x}",
            path=path, offset=offset)
    return payload
