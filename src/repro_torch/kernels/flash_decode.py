"""Flash decode: the CUDA kernels and their plain PyTorch versions.

The counterpart of ``repro/kernels/flash_decode.py`` (``ops.flash_decode``)
and, at the model's layout, of ``repro/models/layers.py::decode_attention``:
one query token of GQA attention over the first ``cache_len`` positions of
a KV cache, scores and softmax in float32, scale ``1/√d``, the result in
q's dtype (float32 or bfloat16).

* :func:`decode_attention` — the model layout: ``q (B, H, d)``, caches
  ``(B, T, Hkv, d)`` read by their strides (a unit stride on ``d``),
  ``cache_len`` an int32 tensor holding one length or one per batch row,
  or a Python int; returns ``(B, H, d)``.
* :func:`flash_decode` — the TPU kernel's layout: ``q (H, d)``, ``k, v
  (Hkv, S, d)``; the same kernels on strided views, no copy.

On CUDA tensors the wrapper launches ``csrc/flash_decode.cu``: ``fd_split``
writes a float32 partial ``(m, l, acc)`` per chunk of :data:`CHUNK`
positions and kv head, ``fd_combine`` merges the chunks below
``cache_len``; ``cache_len`` stays on the device.  On CPU tensors it runs
the plain version, the reference's einsum form
(:func:`decode_attention_plain` runs it on any device).
:func:`split_plain` and :func:`combine_plain` are the plain versions of
the two kernels, and compose to the same function.  ``cache_len <= 0``
gives 0 on the kernel route (the reference averages all of V there;
decoding never asks for it).  ``LAUNCHES`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE", "DTYPES",
           "CHUNK", "decode_attention", "decode_attention_plain",
           "flash_decode", "split_plain", "combine_plain"]

KERNEL_SOURCE = "flash_decode"  # csrc/flash_decode.cu

#: dtypes the kernels take, with the source's `enum DType` codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: positions per split block (kChunk of the source)
CHUNK = 256

#: kernel launches, counted where each kernel is launched
LAUNCHES = {"flash_decode": 0, "flash_decode_combine": 0}

NEG_INF = -1e30
_GRID_YZ = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        lib.fd_chunk.argtypes = []
        lib.fd_chunk.restype = i
        lib.fd_split.argtypes = [vp, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll,
                                 vp, i, i, i, i, i, i, i, vp, vp, vp]
        lib.fd_split.restype = i
        lib.fd_combine.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, vp, vp]
        lib.fd_combine.restype = i
        if lib.fd_chunk() != CHUNK:
            raise RuntimeError(f"csrc/flash_decode.cu splits by "
                               f"{lib.fd_chunk()} positions, the wrapper by "
                               f"{CHUNK}")
        lib._repro_sigs = True
    return lib


def _kernel_shape(q, k, v, cache_len) -> tuple:
    """(B, T, Hkv, G, d, len_stride), refusing what the kernels cannot
    address: a non-unit stride on d, a batch or kv head count past the
    grid."""
    B, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride on d")
    if B > _GRID_YZ or Hkv > _GRID_YZ:
        raise ValueError(f"B={B} and Hkv={Hkv} must be <= {_GRID_YZ}")
    return B, T, Hkv, H // Hkv, d, int(cache_len.numel() > 1)


def partials_shape(B: int, T: int, Hkv: int, G: int, d: int) -> tuple:
    """Shapes of the float32 partials ``(ml, acc)`` of a split."""
    nc = -(-T // CHUNK)
    return (B, Hkv, nc, G, 2), (B, Hkv, nc, G, d)


def launch_split(q, k, v, cache_len):
    """One ``fd_split`` launch on checked CUDA operands; returns the
    partials ``(ml, acc)`` (chunks at or past cache_len left unwritten)."""
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
                cache_len.data_ptr(), len_stride, B, T, Hkv, G, d,
                DTYPES[q.dtype], ml.data_ptr(), acc.data_ptr(), stream)
        LAUNCHES["flash_decode"] += 1
        if err:
            raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    return ml, acc


def launch_combine(ml, acc, cache_len, T: int, dtype):
    """One ``fd_combine`` launch over a split's partials; returns
    ``(B, H, d)`` in ``dtype``."""
    B, Hkv, _, G, d = acc.shape
    out = torch.empty((B, Hkv * G, d), dtype=dtype, device=acc.device)
    if out.numel() and T:
        lib = _lib()
        with torch.cuda.device(acc.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fd_combine(
                ml.data_ptr(), acc.data_ptr(), cache_len.data_ptr(),
                int(cache_len.numel() > 1), B, T, Hkv, G, d, DTYPES[dtype],
                out.data_ptr(), stream)
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


def _lens(cache_len, B: int, T: int):
    return cache_len.reshape(-1).expand(B).long().clamp(max=T)


def split_plain(q, k, v, cache_len):
    """``fd_split``'s partials in torch ops: per chunk of CHUNK positions
    and kv head, the max m of the pre-scaled scores below cache_len, l =
    Σ exp(s - m) and acc = Σ exp(s - m)·v; chunks at or past cache_len hold
    m = -inf, l = 0, acc = 0 (the kernel leaves them unwritten)."""
    cache_len = check_operands(q, k, v, cache_len)
    B, H, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    ml_shape, acc_shape = partials_shape(B, T, Hkv, G, d)
    nc = ml_shape[2]
    pad = nc * CHUNK - T
    qs = q.reshape(B, Hkv, G, d).float() * (1.0 / (d ** 0.5))
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhgd,bthd->bhgt", qs, kp).reshape(B, Hkv, G, nc, CHUNK)
    pos = torch.arange(nc * CHUNK, device=q.device).reshape(nc, CHUNK)
    valid = pos[None] < _lens(cache_len, B, T)[:, None, None]  # (B, nc, C)
    s = torch.where(valid[:, None, None], s, -torch.inf)
    m = s.amax(dim=-1)                                          # (B,Hkv,G,nc)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgct,bcthd->bhgcd", p,
                       vp.reshape(B, nc, CHUNK, Hkv, d))
    ml = torch.stack([m, p.sum(dim=-1)], dim=-1)                # (B,Hkv,G,nc,2)
    return ml.permute(0, 1, 3, 2, 4).contiguous(), \
        acc.permute(0, 1, 3, 2, 4).contiguous()


def combine_plain(ml, acc, cache_len, T: int, dtype):
    """``fd_combine`` in torch ops: merge the chunks below cache_len."""
    B, Hkv, nc, G, d = acc.shape
    pos0 = torch.arange(nc, device=acc.device) * CHUNK
    below = pos0[None] < _lens(cache_len, B, T)[:, None]       # (B, nc)
    below = below[:, None, :, None]
    m = torch.where(below, ml[..., 0], -torch.inf)
    M = m.amax(dim=2, keepdim=True)
    scale = torch.where(below, torch.exp(m - M), 0.0)           # (B,Hkv,nc,G)
    L = (ml[..., 1] * scale).sum(dim=2)
    o = (acc * scale[..., None]).sum(dim=2)
    inv = torch.where(L > 0, 1.0 / L, 0.0)
    return (o * inv[..., None]).reshape(B, Hkv * G, d).to(dtype)


def decode_attention_plain(q, k, v, cache_len):
    """The decode attention in plain torch ops, on any device."""
    return attention_plain(q, k, v, check_operands(q, k, v, cache_len))


# ----------------------------------------------------------- dispatch
def decode_attention(q, k, v, cache_len):
    """One-token GQA attention at the model's layout: the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors."""
    cache_len = check_operands(q, k, v, cache_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, cache_len)
    if q.device.type == "cuda":
        ml, acc = launch_split(q, k, v, cache_len)
        return launch_combine(ml, acc, cache_len, k.shape[1], q.dtype)
    raise ValueError(f"no flash decode for device {q.device}")


def flash_decode(q, k, v, cache_len):
    """The TPU kernel's layout: q (H, d), k/v (Hkv, S, d) -> (H, d)."""
    if q.dim() != 2 or k.dim() != 3:
        raise ValueError(f"q must be (H, d) and k, v (Hkv, S, d), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    return decode_attention(q[None], k.permute(1, 0, 2)[None],
                            v.permute(1, 0, 2)[None], cache_len)[0]
