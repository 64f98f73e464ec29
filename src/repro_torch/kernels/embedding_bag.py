"""EmbeddingBag: the CUDA kernel and its plain PyTorch version.

The counterpart of ``repro/kernels/embedding_bag.py`` behind
``ops.embedding_bag``: ``out[b] = Σ_l w[b,l]·table[idx[b,l]]`` over a
``(N, D)`` table in float32 or bfloat16, ``indices (B, L)`` int32
with ``idx < 0`` a masked slot, ``weights (B, L)`` (cast to the table's
dtype, as the reference casts them) or None for weight 1.  ``mode="mean"``
divides by the masked weight sum, at least 1e-9 (an all-masked bag gives
0).  The result has the table's dtype; both versions accumulate in float32
and round once.

A masked slot reads no row and adds exactly 0.  The reference reads row 0
and multiplies it by 0, so the two differ only where row 0 is not finite.
An index ``>= N`` is refused (torch would fault where ``jnp.take`` fills):
for CPU tensors the call raises; for CUDA tensors the kernel reads no row
for it, adds nothing, and sets a device word that :func:`raise_bad_index`
reads, so a serving step never waits on the host for the check (the
serving entry points check host batches before they move to the card).

The wrapper runs the kernel (``csrc/embedding_bag.cu``) for CUDA tensors
and the plain version for CPU tensors; there is no other route.  The
launch's layout is decided here (:func:`plan`): 16-byte or scalar row
loads, the lanes a bag, and whether the launch is smaller than one wave
of the card (then the kernel keeps more row loads in flight a lane).
``embedding_bag_plain`` runs the plain version on any device.
``LAUNCHES`` counts kernel launches.

:func:`embedding_bag` is differentiable (:class:`Bag`, a
``torch.autograd.Function``): its forward is the kernel on CUDA tensors
and the plain version on CPU tensors, as above; its backward is plain
torch on either.  The reference has no backward kernel either: its
training differentiates the XLA gather-and-sum (``ops.embedding_bag(
use_pallas=False)``), whose gradient sends ``grad_out[b] * w[b,l] /
denom[b]`` to row ``idx[b,l]`` for each unmasked slot; :func:`bag_backward`
is that, one ``index_add_`` over the flat slots, and the weights'
gradient when they need one.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "KERNEL_SOURCE", "DTYPES",
           "plan", "card_plan", "wave_threads", "Bag", "bag_backward",
           "embedding_bag", "embedding_bag_plain", "raise_bad_index"]

KERNEL_SOURCE = "embedding_bag"  # csrc/embedding_bag.cu

#: table dtypes the kernel takes, with the source's `enum DType` codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches, counted where the kernel is launched
LAUNCHES = {"embedding_bag": 0}

MODES = ("sum", "mean")

#: per CUDA device, the int32 word the kernel sets on an index >= N
_BAD_INDEX: dict = {}
#: per CUDA device, the threads one wave of the card holds
_WAVE: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- checks
def check_operands(table, indices, weights, mode: str):
    """Dtype, device, shape and contiguity of the operands, and the index
    range of CPU indices; returns the weights in the table's dtype (or
    None)."""
    if table.dtype not in DTYPES:
        raise TypeError(f"table must be one of {sorted(map(str, DTYPES))}, "
                        f"got {table.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be torch.int32, got {indices.dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"table must be (N, D) and indices (B, L), got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError(f"indices is on {indices.device}, table on "
                         f"{table.device}")
    if weights is not None:
        if weights.shape != indices.shape:
            raise ValueError(f"weights must be {tuple(indices.shape)}, got "
                             f"{tuple(weights.shape)}")
        if weights.device != table.device:
            raise ValueError(f"weights is on {weights.device}, table on "
                             f"{table.device}")
        weights = weights.to(table.dtype)
    if not (table.is_contiguous() and indices.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("table, indices and weights must be contiguous")
    if indices.device.type == "cpu" and indices.numel() \
            and int(indices.max()) >= table.shape[0]:
        raise IndexError(f"an index is >= the table's {table.shape[0]} rows")
    return weights


# ----------------------------------------------------------- CUDA route
def _bind(lib):
    """``lib``, a loaded ``csrc/embedding_bag.cu``, with its C signature."""
    if not getattr(lib, "_repro_sigs", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.eb_embedding_bag.argtypes = [vp, vp, vp, ll, i, i, ll, i, i, i, i,
                                         i, vp, vp, vp]
        lib.eb_embedding_bag.restype = i
        lib._repro_sigs = True
    return lib


def _lib():
    from . import _build

    return _bind(_build.load(KERNEL_SOURCE))


def plan(table, indices, wave: int) -> dict:
    """The launch's layout: ``vec`` elements a lane loads (16 bytes when
    every row starts 16-byte aligned, else 1), ``tpb``, the fewest lanes
    (a power of two <= 32) that cover a row, and ``small``: the launch's
    threads (a group of ``tpb`` a bag) fill less than one wave of the
    card, ``wave`` threads (its SMs x the threads an SM holds)."""
    D = table.shape[1]
    wide = 16 // table.element_size()
    vec = wide if D % wide == 0 and table.data_ptr() % 16 == 0 else 1
    tpb = 1
    while tpb < 32 and tpb * vec < D:
        tpb *= 2
    return {"vec": vec, "tpb": tpb, "small": indices.shape[0] * tpb < wave}


def wave_threads(device) -> int:
    """The threads one wave of the CUDA ``device`` holds (its SMs x the
    threads an SM holds), read from the card once."""
    wave = _WAVE.get(device)
    if wave is None:
        props = torch.cuda.get_device_properties(device)
        wave = _WAVE[device] = props.multi_processor_count \
            * props.max_threads_per_multi_processor
    return wave


def card_plan(table, indices) -> dict:
    """:func:`plan` on the card that holds ``table``."""
    return plan(table, indices, wave_threads(table.device))


def _bad_word(device) -> torch.Tensor:
    word = _BAD_INDEX.get(device)
    if word is None:
        word = _BAD_INDEX[device] = torch.zeros(1, dtype=torch.int32,
                                                device=device)
    return word


def raise_bad_index(device) -> None:
    """Raise IndexError if a kernel launch on ``device`` met an index >= N
    since the last call, and clear the record.  One device-to-host read.
    A CPU device records nothing: there the call itself raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    word = _BAD_INDEX.get(device)
    if word is not None and int(word):
        del _BAD_INDEX[device]
        raise IndexError(f"an embedding_bag launch on {device} met an index "
                         f">= its table's rows")


def launch_bag(table, indices, weights, mode: str):
    """One ``eb_embedding_bag`` launch on checked CUDA operands; an index
    >= N reads nothing and sets the device's word (:func:`raise_bad_index`)."""
    B, L = indices.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B and D:
        p = card_plan(table, indices)
        lib = _lib()
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.eb_embedding_bag(
                table.data_ptr(), indices.data_ptr(),
                None if weights is None else weights.data_ptr(), B, L, D,
                table.shape[0], DTYPES[table.dtype], p["vec"],
                int(p["small"]), p["tpb"], int(mode == "mean"),
                _bad_word(table.device).data_ptr(), out.data_ptr(), stream)
        LAUNCHES["embedding_bag"] += 1
        if err:
            raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    return out


# ------------------------------------------------------- plain version
def bag_plain(table, indices, weights, mode: str):
    """The kernel's contract in torch ops on checked operands: masked slots
    (and, as in the kernel, slots past the table) gather nothing, float32
    accumulation, one rounding."""
    mask = (indices >= 0) & (indices < table.shape[0])
    w = torch.ones(indices.shape, device=table.device) if weights is None \
        else weights.float()
    w = torch.where(mask, w, 0.0)
    rows = table[torch.where(mask, indices, 0).long()]  # (B, L, D)
    rows = torch.where(mask[..., None], rows, 0).float()
    out = torch.einsum("bld,bl->bd", rows, w)
    if mode == "mean":
        out = out / w.sum(dim=1, keepdim=True).clamp(min=1e-9)
    return out.to(table.dtype)


def embedding_bag_plain(table, indices, weights=None, *, mode: str = "sum"):
    """The embedding bag in plain torch ops, on any device."""
    weights = check_operands(table, indices, weights, mode)
    return bag_plain(table, indices, weights, mode)


# ----------------------------------------------------------- autograd
def _bag(table, indices, weights, mode: str):
    """The kernel for CUDA tensors, the plain version for CPU tensors and
    for ``meta`` ones (the dry run's shapes, which have no kernel)."""
    if table.device.type == "cuda":
        return launch_bag(table, indices, weights, mode)
    if table.device.type in ("cpu", "meta"):
        return bag_plain(table, indices, weights, mode)
    raise ValueError(f"no embedding bag for device {table.device}")


def bag_backward(grad_out, table, indices, weights, mode: str,
                 need_weights: bool):
    """Gradients of the bag: ``(grad_table, grad_weights or None)``.
    ``grad_table[idx[b,l]] += grad_out[b] * w[b,l] / denom[b]`` in float32,
    one ``index_add_`` over all ``B x L`` slots, a masked slot or one past
    the table adding its 0 to row 0 (as the reference's autodiff adds
    ``grad * 0`` at ``max(idx, 0)``); ``grad_weights[b,l] = (grad_out[b] .
    row - [mean] grad_out[b] . out[b]) / denom[b]`` at the slots in range
    and 0 elsewhere.  No host sync."""
    N, D = table.shape
    B, L = indices.shape
    mask = (indices >= 0) & (indices < N)
    w = torch.ones(indices.shape, device=table.device) if weights is None \
        else weights.float()
    w = torch.where(mask, w, 0.0)
    g = grad_out.float()
    if mode == "mean":
        g = g / w.sum(dim=1, keepdim=True).clamp(min=1e-9)
    rows = torch.where(mask, indices, 0).reshape(-1).long()
    contrib = (g[:, None, :] * w[:, :, None]).reshape(B * L, D)
    grad_table = torch.zeros((N, D), dtype=torch.float32,
                             device=table.device).index_add_(0, rows, contrib)
    del contrib
    grad_w = None
    if need_weights:
        dot = torch.einsum("bld,bd->bl",
                           table[rows].float().reshape(B, L, D), g)
        if mode == "mean":
            out = bag_plain(table, indices, weights, mode).float()
            dot = dot - (g * out).sum(-1, keepdim=True)
        grad_w = torch.where(mask, dot, 0.0)
    return grad_table.to(table.dtype), grad_w


class Bag(torch.autograd.Function):
    """The bag under autograd: the kernel (CUDA tensors) or the plain
    version (CPU tensors) forward, :func:`bag_backward` backward."""

    @staticmethod
    def forward(ctx, table, indices, weights, mode):
        ctx.mode = mode
        ctx.save_for_backward(table, indices, weights)
        return _bag(table, indices, weights, mode)

    @staticmethod
    def backward(ctx, grad_out):
        table, indices, weights = ctx.saved_tensors
        need_w = weights is not None and ctx.needs_input_grad[2]
        grad_table, grad_w = bag_backward(grad_out, table, indices, weights,
                                          ctx.mode, need_w)
        if not ctx.needs_input_grad[0]:
            grad_table = None
        if grad_w is not None:
            grad_w = grad_w.to(weights.dtype)
        return grad_table, None, grad_w, None


# ----------------------------------------------------------- dispatch
def embedding_bag(table, indices, weights=None, *, mode: str = "sum"):
    """EmbeddingBag: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; differentiable in the table and the weights
    (:class:`Bag`) when autograd asks for it.  Other calls skip
    ``Bag.apply``: through it, MIND's serve_p99 measured slower on an
    H100 (PERF.md, Findings)."""
    weights = check_operands(table, indices, weights, mode)
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        return Bag.apply(table, indices, weights, mode)
    return _bag(table, indices, weights, mode)
