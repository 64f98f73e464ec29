"""The port's flash decode (plain versions, on the CPU) against the JAX
package's Pallas kernel (interpret mode), its oracle and the model's
``decode_attention``.

Tolerances, the reference's own: float32 2e-4; bfloat16 inputs against the
float32 oracle 5e-2.  The split-KV pair the CUDA kernels compute is held
to the whole function here through its plain versions (``split_plain`` +
``combine_plain``); the kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jax_fd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import decode_attention as jax_decode_attention  # noqa: E402

from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.cases import (DECODE_BATCH, DECODE_CASES,  # noqa: E402
                                       decode_case, decode_lens)
from repro_torch.models import layers  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SWEEP = [(2, 4, 1024, 64, 256), (8, 1, 512, 128, 128), (1, 8, 2048, 64, 512),
         (4, 7, 512, 32, 128)]


@pytest.mark.parametrize("Hkv,G,S,d,blk", SWEEP)
def test_flash_decode_matches_jax_kernel_and_oracle(Hkv, G, S, d, blk):
    rng = np.random.default_rng(S + d)
    q = rng.normal(size=(Hkv * G, d)).astype(np.float32)
    k = rng.normal(size=(Hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(Hkv, S, d)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for cache_len in [S, S - 17, blk + 1, 1]:
        got = fdk.flash_decode(tq, tk, tv, cache_len).numpy()
        jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.int32(cache_len))
        np.testing.assert_allclose(
            got, np.asarray(jax_fd(*jargs, block_kv=blk)), **TOL)
        np.testing.assert_allclose(
            got, np.asarray(jref.flash_decode_ref(*jargs)), **TOL)
        np.testing.assert_allclose(
            tref.flash_decode_ref(tq, tk, tv, cache_len).numpy(),
            np.asarray(jref.flash_decode_ref(*jargs)), **TOL)


def test_flash_decode_bf16():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    k = rng.normal(size=(2, 512, 64)).astype(np.float32)
    v = rng.normal(size=(2, 512, 64)).astype(np.float32)
    got = fdk.flash_decode(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                           511)
    assert got.dtype == torch.bfloat16
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(511))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("per_row", [False, True])
def test_model_layout_matches_jax_decode_attention(per_row):
    """As the reference pins its Pallas kernel to ``decode_attention``: the
    port's decode attention at the (B, 1, H, d) / (B, T, Hkv, d) layout,
    and the TPU layout of each row, equal the JAX function."""
    rng = np.random.default_rng(5)
    B, H, Hkv, d, T = 2, 8, 2, 32, 256
    q = rng.normal(size=(B, 1, H, d)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, d)).astype(np.float32)
    length = np.array([200, 57], np.int32) if per_row else np.int32(200)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(length)))
    tl = torch.as_tensor(length)
    got = layers.decode_attention(*(torch.as_tensor(a) for a in (q, k, v)), tl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b in range(B):
        row = fdk.flash_decode(torch.as_tensor(q[b, 0]),
                               torch.as_tensor(k[b]).permute(1, 0, 2),
                               torch.as_tensor(v[b]).permute(1, 0, 2),
                               int(length[b] if per_row else length))
        np.testing.assert_allclose(row.numpy(), want[b, 0], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hkv,G,S,d", DECODE_CASES)
def test_split_and_combine_compose_to_the_function(Hkv, G, S, d, dtype):
    """The chunked online softmax the two CUDA kernels compute, in their
    plain versions, equals the einsum form at every cache length of the
    sweep (one chunk, a chunk + 1, a ragged tail, full) and past T."""
    q, k, v = (torch.as_tensor(a).to(dtype) for a in decode_case(
        np.random.default_rng(S), DECODE_BATCH, Hkv, G, S, d))
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for n in (*decode_lens(S, fdk.CHUNK), fdk.CHUNK, S + 5):
        lens = torch.tensor(n, dtype=torch.int32)
        ml, acc = fdk.split_plain(q, k, v, lens)
        got = fdk.combine_plain(ml, acc, lens, S, dtype)
        want = fdk.decode_attention_plain(q, k, v, lens)
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
        nc = -(-min(n, S) // fdk.CHUNK)
        assert torch.isinf(ml[:, :, nc:, :, 0]).all()
        assert (ml[:, :, nc:, :, 1] == 0).all()


def test_per_row_lengths_split_and_combine():
    q, k, v = (torch.as_tensor(a) for a in decode_case(
        np.random.default_rng(2), 3, 2, 3, 700, 16))
    lens = torch.tensor([700, 1, 300], dtype=torch.int32)
    ml, acc = fdk.split_plain(q, k, v, lens)
    torch.testing.assert_close(fdk.combine_plain(ml, acc, lens, 700,
                                                 torch.float32),
                               fdk.decode_attention(q, k, v, lens), **TOL)


def test_wrapper_refusals():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 16, 2, 8)
    with pytest.raises(TypeError, match="dtype"):
        fdk.decode_attention(q, k.bfloat16(), k.bfloat16(), 3)
    with pytest.raises(TypeError, match="int32"):
        fdk.decode_attention(q, k, k, torch.tensor(3))
    with pytest.raises(ValueError, match="do not fit"):
        fdk.decode_attention(torch.zeros(2, 3, 8), k, k, 3)
    with pytest.raises(ValueError, match="1 or B"):
        fdk.decode_attention(q, k, k, torch.tensor([1, 2, 3],
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="is on"):
        fdk.decode_attention(q, k.to("meta"), k, 3)
    with pytest.raises(ValueError, match=r"\(H, d\)"):
        fdk.flash_decode(q, k, k, 3)
