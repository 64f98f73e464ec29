"""Flash decode: the CUDA kernels and their plain PyTorch versions.

The counterpart of ``repro/kernels/flash_decode.py`` (``ops.flash_decode``)
and, at the model's layout, of ``repro/models/layers.py::decode_attention``:
one query token of GQA attention over the first ``cache_len`` positions of
a KV cache, scores and softmax in float32, scale ``1/√d``, the result in
q's dtype (float32 or bfloat16).  ``cache_len <= 0`` gives the reference's
answer there, the mean of V over all T positions (its -1e30 fill makes the
softmax uniform).

* :func:`decode_attention` — the model layout: ``q (B, H, d)``, caches
  ``(B, T, Hkv, d)`` read by their strides (a unit stride on ``d``),
  ``cache_len`` an int32 tensor holding one length or one per batch row,
  or a Python int; returns ``(B, H, d)``.
* :func:`flash_decode` — the TPU kernel's layout: ``q (H, d)``, ``k, v
  (Hkv, S, d)``; the same kernels on strided views, no copy.

On CUDA tensors the wrapper launches ``csrc/flash_decode.cu``: ``fd_split``
writes a float32 partial ``(m, l, acc)`` per split and query head,
``fd_combine`` merges the splits of each row; ``cache_len`` stays on the
device, where both kernels derive the splits from it by the rule of
:func:`split_plan` (the source's ``split_plan``).  The caches must be
16-byte aligned with 16-byte aligned strides and ``d`` one of
:data:`KERNEL_DIMS`; the wrapper refuses other operands.  On CPU tensors
it runs the plain version, the reference's einsum form
(:func:`decode_attention_plain` runs it on any device).
:func:`split_plain` and :func:`combine_plain` are the plain versions of
the two kernels on the same partition, and compose to the same function.
``LAUNCHES`` counts each kernel's launches.

A cache whose sequence is cut into P pieces of T positions (tensor
parallelism, ``models.layers.decode_attention_split``): :func:`decode_piece`
runs the split on one piece at its ``offset``, by :func:`piece_plan` (a
piece wholly past ``cache_len`` has no split: the neutral partial m = -inf,
l = 0, acc = 0; ``cache_len <= 0`` covers every piece whole with zero
scores), and :func:`combine_pieces` merges the P pieces' partials stacked
on a leading axis, each piece's split count its own.  Both launch the
kernels on CUDA tensors and run the plain versions on CPU ones.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE", "DTYPES",
           "TILE", "HEAD_GROUP", "TARGET_BLOCKS", "KERNEL_DIMS", "split_cap",
           "split_plan", "piece_plan", "max_splits", "split_boundaries",
           "partials_shape", "decode_attention", "decode_attention_plain",
           "flash_decode", "split_plain", "combine_plain", "decode_piece",
           "combine_pieces"]

KERNEL_SOURCE = "flash_decode"  # csrc/flash_decode.cu

#: dtypes the kernels take, with the source's `enum DType` codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: positions a staged tile; every split but a row's last is a multiple
#: (kTile of the source)
TILE = 64
#: query heads one thread block takes (the M of the tensor-core product;
#: kHeads of the source): G > 16 runs as ceil(G / 16) head groups
HEAD_GROUP = 16
#: blocks with work the rule aims at: two on each of the H100's 132 SMs
#: (kTarget of the source)
TARGET_BLOCKS = 264
#: head sizes the split kernel is built for
KERNEL_DIMS = (16, 32, 64, 128)

#: kernel launches, counted where each kernel is launched
LAUNCHES = {"flash_decode": 0, "flash_decode_combine": 0}

NEG_INF = -1e30
_GRID_YZ = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ the rule
def split_cap(B: int, Hkv: int, G: int) -> int:
    """Most splits of one (row, kv head): :data:`TARGET_BLOCKS` over the
    blocks a split count of 1 gives, at least 1."""
    return max(1, TARGET_BLOCKS // (B * Hkv * -(-G // HEAD_GROUP)))


def split_plan(cache_len: int, T: int, B: int, Hkv: int, G: int) -> tuple:
    """``(covered, span, n)``: a row of length ``cache_len`` covers
    ``min(cache_len, T)`` positions (all T for ``cache_len <= 0``), cut
    into ``n`` splits of ``span`` positions, a multiple of TILE, the last
    one ragged; ``n <= split_cap``.  The source's ``split_plan``."""
    covered = T if cache_len <= 0 else min(cache_len, T)
    tiles = -(-covered // TILE)
    per = max(1, -(-tiles // split_cap(B, Hkv, G)))
    return covered, per * TILE, -(-tiles // per)


def piece_plan(cache_len: int, offset: int, T: int, B: int, Hkv: int,
               G: int) -> tuple:
    """:func:`split_plan` of the piece of ``T`` positions that starts at
    position ``offset`` of a longer sequence: its positions below
    ``cache_len`` (``n = 0`` where the piece lies wholly past it), or all
    ``T`` with zero scores for ``cache_len <= 0``.  The source's
    ``piece_plan``; offset 0 of the whole sequence is ``split_plan``."""
    if cache_len <= 0:
        return split_plan(cache_len, T, B, Hkv, G)
    local = cache_len - offset
    if local <= 0:
        return 0, TILE, 0
    return split_plan(min(local, T), T, B, Hkv, G)


def max_splits(T: int, B: int, Hkv: int, G: int) -> int:
    """The largest split count the rule gives at any length: the partials
    are sized from T by it."""
    return min(split_cap(B, Hkv, G), -(-T // TILE))


def split_boundaries(T: int, B: int, Hkv: int, G: int) -> list:
    """The lengths in ``[2, T]`` whose split plan differs from that of the
    length one below: each first length of a new tile count where the
    split span or count changes."""
    out, prev = [], split_plan(1, T, B, Hkv, G)[1:]
    for tiles in range(2, -(-T // TILE) + 1):
        n = (tiles - 1) * TILE + 1
        plan = split_plan(n, T, B, Hkv, G)[1:]
        if plan != prev:
            out.append(n)
        prev = plan
    return out


def partials_shape(B: int, T: int, Hkv: int, G: int, d: int) -> tuple:
    """Shapes of the float32 partials ``(ml, acc)`` of a split."""
    ns = max_splits(T, B, Hkv, G)
    return (B, Hkv, ns, G, 2), (B, Hkv, ns, G, d)


# ---------------------------------------------------------------- checks
def check_operands(q, k, v, cache_len):
    """Dtype, device, shape and strides of the operands; returns
    ``cache_len`` as an int32 tensor of 1 or B entries on q's device."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {sorted(map(str, DTYPES))}, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k, v must have q's dtype {q.dtype}, got {k.dtype} "
                        f"and {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, d) and k, v (B, T, Hkv, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and d, H a multiple of Hkv)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.tensor(int(cache_len), dtype=torch.int32,
                                 device=q.device)
    if cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be torch.int32, got {cache_len.dtype}")
    if cache_len.device != q.device:
        raise ValueError(f"cache_len is on {cache_len.device}, q on {q.device}")
    if cache_len.numel() not in (1, B):
        raise ValueError(f"cache_len must hold 1 or B={B} lengths, got "
                         f"{cache_len.numel()}")
    return cache_len


# ----------------------------------------------------------- CUDA route
def _lib():
    from . import _build

    lib = _build.load(KERNEL_SOURCE)
    if not getattr(lib, "_repro_sigs", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("fd_tile", "fd_head_group", "fd_target"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.fd_split.argtypes = [vp, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll,
                                 vp, i, ll, i, i, i, i, i, i, i, vp, vp, vp]
        lib.fd_split.restype = i
        lib.fd_combine.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, i,
                                   vp, vp]
        lib.fd_combine.restype = i
        got = (lib.fd_tile(), lib.fd_head_group(), lib.fd_target())
        if got != (TILE, HEAD_GROUP, TARGET_BLOCKS):
            raise RuntimeError(f"csrc/flash_decode.cu's (tile, head group, "
                               f"target) {got} differ from the wrapper's "
                               f"{(TILE, HEAD_GROUP, TARGET_BLOCKS)}")
        lib._repro_sigs = True
    return lib


def _aligned(t) -> bool:
    """16-byte aligned data and strides: what the kernel's cp.async copies
    need."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(st * e % 16 == 0
                                          for st in t.stride()[:3])


def _kernel_shape(q, k, v, cache_len) -> tuple:
    """(B, T, Hkv, G, d, len_stride), refusing what the kernels cannot
    address: a non-unit stride on d, a head size they are not built for,
    caches off 16-byte alignment, a batch or kv head count past the
    grid."""
    B, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride on d")
    if d not in KERNEL_DIMS:
        raise ValueError(f"the flash-decode kernel takes d in {KERNEL_DIMS}, "
                         f"got {d}")
    if not (_aligned(k) and _aligned(v)):
        raise ValueError("k and v need 16-byte aligned data and strides "
                         "(the kernel stages them with 16-byte copies)")
    G = H // Hkv
    if B > _GRID_YZ or Hkv * -(-G // HEAD_GROUP) > _GRID_YZ:
        raise ValueError(f"B={B} and Hkv * head groups must be <= {_GRID_YZ}")
    return B, T, Hkv, G, d, int(cache_len.numel() > 1)


def launch_split(q, k, v, cache_len, offset: int = 0):
    """One ``fd_split`` launch on checked CUDA operands, the caches being
    the piece at ``offset`` of the sequence (0: the whole cache); returns
    the partials ``(ml, acc)`` (splits past a row's count left
    unwritten)."""
    B, T, Hkv, G, d, len_stride = _kernel_shape(q, k, v, cache_len)
    ml_shape, acc_shape = partials_shape(B, T, Hkv, G, d)
    ml = torch.empty(ml_shape, dtype=torch.float32, device=q.device)
    acc = torch.empty(acc_shape, dtype=torch.float32, device=q.device)
    if q.numel() and T:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fd_split(
                q.data_ptr(), q.stride(0), q.stride(1),
                k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
                v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
                cache_len.data_ptr(), len_stride, int(offset), B, T, Hkv, G,
                d, DTYPES[q.dtype], ml_shape[2], ml.data_ptr(),
                acc.data_ptr(), stream)
        LAUNCHES["flash_decode"] += 1
        if err:
            raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    return ml, acc


def _pieces(ml, acc) -> tuple:
    """``(ml, acc)`` with a leading pieces axis (one piece where they have
    none) and their (P, B, Hkv, ns, G, d)."""
    if acc.dim() == 5:
        ml, acc = ml[None], acc[None]
    return ml, acc, acc.shape


def launch_combine(ml, acc, cache_len, T: int, dtype):
    """One ``fd_combine`` launch over the partials of a cache, or of the P
    pieces of ``T`` positions each stacked on a leading axis (piece p at
    offset ``p * T``); returns ``(B, H, d)`` in ``dtype``."""
    ml, acc, (P, B, Hkv, ns, G, d) = _pieces(ml, acc)
    if 4 * P * ns > 48 * 1024:
        raise ValueError(f"{P} pieces x {ns} splits: the combine's weights "
                         "exceed 48 KB of shared memory")
    ml, acc = ml.contiguous(), acc.contiguous()
    out = torch.empty((B, Hkv * G, d), dtype=dtype, device=acc.device)
    if out.numel() and T:
        lib = _lib()
        with torch.cuda.device(acc.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fd_combine(
                ml.data_ptr(), acc.data_ptr(), cache_len.data_ptr(),
                int(cache_len.numel() > 1), B, T, Hkv, G, d, DTYPES[dtype], ns,
                P, out.data_ptr(), stream)
        LAUNCHES["flash_decode_combine"] += 1
        if err:
            raise RuntimeError(f"flash_decode_combine launch failed: CUDA "
                               f"error {err}")
    return out


# ------------------------------------------------------- plain versions
def attention_plain(q, k, v, cache_len):
    """The reference's einsum form (``layers.decode_attention``) on checked
    operands."""
    B, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, d).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) / (d ** 0.5)
    mask = torch.arange(T, device=q.device)[None, None, None, :] < \
        cache_len.reshape(-1, 1, 1, 1)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return out.reshape(B, H, d).to(q.dtype)


def _row_lens(cache_len, B: int) -> list:
    return [int(n) for n in cache_len.reshape(-1).expand(B).tolist()]


def split_plain(q, k, v, cache_len, offset: int = 0):
    """``fd_split``'s partials in torch ops, on the partition of
    :func:`piece_plan` (the caches the piece at ``offset``; 0 with the
    whole cache is :func:`split_plan`'s): per split and query head, the
    max m of the scaled scores, l = Σ exp(s - m) and acc = Σ exp(s - m)·v
    over the split's positions (every score 0 where ``cache_len <= 0``);
    splits past a row's count hold m = -inf, l = 0, acc = 0 (the kernel
    leaves them unwritten), so a piece wholly past ``cache_len`` is all
    neutral.  Reads the lengths on the host: a reference, not a decode
    step."""
    cache_len = check_operands(q, k, v, cache_len)
    B, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    ml_shape, acc_shape = partials_shape(B, T, Hkv, G, d)
    m = torch.full(ml_shape[:-1], -torch.inf, device=q.device)
    l = torch.zeros(ml_shape[:-1], device=q.device)
    acc = torch.zeros(acc_shape, device=q.device)
    qs = q.reshape(B, Hkv, G, d).float() * (1.0 / (d ** 0.5))
    for b, n in enumerate(_row_lens(cache_len, B)):
        covered, span, ns = piece_plan(n, offset, T, B, Hkv, G)
        if ns == 0:
            continue
        kb, vb = k[b, :covered].float(), v[b, :covered].float()
        s = torch.einsum("hgd,thd->hgt", qs[b], kb)
        if n <= 0:
            s = torch.zeros_like(s)
        pad = ns * span - covered  # the last split's positions past covered
        s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
        s = s.reshape(Hkv, G, ns, span)
        mb = s.amax(dim=-1)                                   # (Hkv, G, ns)
        p = torch.exp(s - mb[..., None])
        vp = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        ab = torch.einsum("hgct,cthd->hgcd", p,
                          vp.reshape(ns, span, Hkv, d))
        m[b, :, :ns] = mb.transpose(1, 2)
        l[b, :, :ns] = p.sum(dim=-1).transpose(1, 2)
        acc[b, :, :ns] = ab.transpose(1, 2)
    return torch.stack([m, l], dim=-1), acc


def combine_plain(ml, acc, cache_len, T: int, dtype):
    """``fd_combine`` in torch ops: merge each row's splits (the count
    from :func:`split_plan`), or those of P pieces of ``T`` positions
    stacked on a leading axis (each piece's count from
    :func:`piece_plan`)."""
    ml, acc, (P, B, Hkv, ns, G, d) = _pieces(ml, acc)
    counts = torch.tensor([[piece_plan(n, p * T, T, B, Hkv, G)[2]
                            for p in range(P)]
                           for n in _row_lens(cache_len, B)],
                          device=acc.device)                   # (B, P)
    # the pieces' splits side by side: (B, Hkv, P * ns, G, ...)
    ml = ml.permute(1, 2, 0, 3, 4, 5).reshape(B, Hkv, P * ns, G, 2)
    acc = acc.permute(1, 2, 0, 3, 4, 5).reshape(B, Hkv, P * ns, G, d)
    below = torch.arange(ns, device=acc.device)[None, None] < counts[..., None]
    below = below.reshape(B, P * ns)[:, None, :, None]         # (B,1,P*ns,1)
    m = torch.where(below, ml[..., 0], -torch.inf)
    M = m.amax(dim=2, keepdim=True)
    scale = torch.where(below, torch.exp(m - M), 0.0)           # (B,Hkv,ns,G)
    L = (torch.where(below, ml[..., 1], 0.0) * scale).sum(dim=2)
    o = (torch.where(below[..., None], acc, 0.0) * scale[..., None]).sum(dim=2)
    inv = torch.where(L > 0, 1.0 / L, 0.0)
    return (o * inv[..., None]).reshape(B, Hkv * G, d).to(dtype)


def decode_attention_plain(q, k, v, cache_len):
    """The decode attention in plain torch ops, on any device."""
    return attention_plain(q, k, v, check_operands(q, k, v, cache_len))


# ----------------------------------------------------------- dispatch
def decode_attention(q, k, v, cache_len):
    """One-token GQA attention at the model's layout: the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors and for ``meta`` ones
    (the dry run's shapes, which have no kernel)."""
    cache_len = check_operands(q, k, v, cache_len)
    if q.device.type in ("cpu", "meta"):
        return attention_plain(q, k, v, cache_len)
    if q.device.type == "cuda":
        if k.shape[1] == 0:  # no positions: the reference's empty sum
            _kernel_shape(q, k, v, cache_len)
            return torch.zeros_like(q)
        ml, acc = launch_split(q, k, v, cache_len)
        return launch_combine(ml, acc, cache_len, k.shape[1], q.dtype)
    raise ValueError(f"no flash decode for device {q.device}")


def decode_piece(q, k, v, cache_len, offset: int):
    """The partials ``(ml, acc)`` of one piece of a sequence-split cache:
    q ``(B, H, d)`` every query head, k, v ``(B, T, Hkv, d)`` the piece at
    ``offset``, ``cache_len`` the whole sequence's length (on the device).
    The split kernel for CUDA tensors, :func:`split_plain` for CPU ones."""
    cache_len = check_operands(q, k, v, cache_len)
    if q.device.type == "cpu":
        return split_plain(q, k, v, cache_len, offset)
    if q.device.type == "cuda":
        return launch_split(q, k, v, cache_len, offset)
    raise ValueError(f"no flash decode for device {q.device}")


def combine_pieces(ml, acc, cache_len, T: int, dtype):
    """The attention of every query head from the P pieces' partials
    stacked ``(P, B, Hkv, ns, G, ...)``, each piece ``T`` positions:
    ``(B, H, d)`` in ``dtype``.  The combine kernel for CUDA tensors,
    :func:`combine_plain` for CPU ones."""
    if acc.device.type == "cpu":
        return combine_plain(ml, acc, cache_len, T, dtype)
    if acc.device.type == "cuda":
        return launch_combine(ml, acc, cache_len, T, dtype)
    raise ValueError(f"no flash decode for device {acc.device}")


def flash_decode(q, k, v, cache_len):
    """The TPU kernel's layout: q (H, d), k/v (Hkv, S, d) -> (H, d)."""
    if q.dim() != 2 or k.dim() != 3:
        raise ValueError(f"q must be (H, d) and k, v (Hkv, S, d), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    return decode_attention(q[None], k.permute(1, 0, 2)[None],
                            v.permute(1, 0, 2)[None], cache_len)[0]
