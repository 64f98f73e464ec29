"""The port's flash decode (plain versions, on the CPU) against the JAX
package's Pallas kernel (interpret mode), its oracle and the model's
``decode_attention``.

Tolerances, the reference's own: float32 2e-4; bfloat16 inputs against the
float32 oracle 5e-2.  The split-KV pair the CUDA kernels compute is held
to the whole function here through its plain versions (``split_plain`` +
``combine_plain``) on the kernel's partition (``split_plan``), whose rule
is checked on its own; the kernels themselves run on the card only
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
    """The split online softmax the two CUDA kernels compute, in their
    plain versions, equals the einsum form at every cache length of the
    sweep (one, a ragged tail, full, each boundary of the split rule and
    one either side) and past T; splits past a length's count hold
    m = -inf, l = 0."""
    q, k, v = (torch.as_tensor(a).to(dtype) for a in decode_case(
        np.random.default_rng(S), DECODE_BATCH, Hkv, G, S, d))
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    bounds = fdk.split_boundaries(S, DECODE_BATCH, Hkv, G)
    for n in (*decode_lens(S, bounds), S + 5):
        lens = torch.tensor(n, dtype=torch.int32)
        ml, acc = fdk.split_plain(q, k, v, lens)
        got = fdk.combine_plain(ml, acc, lens, S, dtype)
        want = fdk.decode_attention_plain(q, k, v, lens)
        assert got.dtype == want.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
        ns = fdk.split_plan(n, S, DECODE_BATCH, Hkv, G)[2]
        assert torch.isfinite(ml[:, :, :ns]).all()
        assert torch.isinf(ml[:, :, ns:, :, 0]).all()
        assert (ml[:, :, ns:, :, 1] == 0).all()


def split_ranges(cache_len, T, B, Hkv, G):
    """The ``[start, end)`` positions of each split of a row, by the rule's
    plan."""
    covered, span, n = fdk.split_plan(cache_len, T, B, Hkv, G)
    return [(s * span, min((s + 1) * span, covered)) for s in range(n)]


#: (B, Hkv, G, T): the served Qwen3-0.6B decode_32k cache and the
#: long_500k one, the reference's sweep at its batch, a batch whose blocks
#: alone pass the target (one split each), head groups (G > 16), ragged T
RULE_SHAPES = [(8, 8, 2, 32768), (1, 8, 2, 524288), (2, 2, 4, 1024),
               (300, 1, 1, 1000), (1, 1, 20, 300), (3, 2, 3, 700)]


@pytest.mark.parametrize("B,Hkv,G,T", RULE_SHAPES)
def test_split_rule_partitions_the_covered_positions(B, Hkv, G, T):
    """At every length (all of them up to a few thousand positions, else
    each boundary and one either side, plus a seeded sample), the splits
    cover ``[0, covered)`` in order with no gap or overlap, each a multiple
    of the tile but the last, never more than ``max_splits`` (what the
    partials hold) nor more blocks than the target where one split a
    (row, kv head) does not already pass it; the plan changes at each
    boundary and nowhere else."""
    bounds = fdk.split_boundaries(T, B, Hkv, G)
    cap = fdk.split_cap(B, Hkv, G)
    units = B * Hkv * -(-G // fdk.HEAD_GROUP)
    if T <= 4096:
        lens = range(-3, T + 10)
    else:
        rng = np.random.default_rng(T)
        lens = sorted({-3, 0, 1, T - 1, T, T + 7,
                       *(x for b in bounds for x in (b - 1, b, b + 1)),
                       *rng.integers(1, T + 1, 300).tolist()})
    ns_max = fdk.max_splits(T, B, Hkv, G)
    assert fdk.partials_shape(B, T, Hkv, G, 8)[0][2] == ns_max
    for n in lens:
        covered, span, ns = fdk.split_plan(n, T, B, Hkv, G)
        assert covered == (T if n <= 0 else min(n, T))
        ranges = split_ranges(n, T, B, Hkv, G)
        assert len(ranges) == ns and 1 <= ns <= min(ns_max, cap)
        assert ranges[0][0] == 0 and ranges[-1][1] == covered
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c and (b - a) % fdk.TILE == 0 and b - a == span
        assert 0 < ranges[-1][1] - ranges[-1][0] <= span
        assert units * ns <= max(fdk.TARGET_BLOCKS, units)
    plans = {n: fdk.split_plan(n, T, B, Hkv, G)[1:] for n in lens}
    for n in lens:
        if n - 1 in plans and n >= 2:
            assert (plans[n] != plans[n - 1]) == (n in bounds), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rule_boundary_lengths_compose_to_the_function(dtype):
    """Where the rule's cap is below the tile count (8 rows x 8 kv heads,
    as served: 4 splits at most), the plain split and combine equal the
    einsum form one below, at and one above every boundary, at 1, T and
    past T, and with per-row lengths drawn from those."""
    B, Hkv, G, S, d = 8, 8, 2, 1024, 16
    q, k, v = (torch.as_tensor(a).to(dtype) for a in decode_case(
        np.random.default_rng(11), B, Hkv, G, S, d))
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    bounds = fdk.split_boundaries(S, B, Hkv, G)
    assert fdk.split_cap(B, Hkv, G) < -(-S // fdk.TILE)
    lens = sorted({1, S, S + 5, *(x for b in bounds for x in (b - 1, b, b + 1))})
    rows = [torch.tensor(n, dtype=torch.int32) for n in lens]
    rng = np.random.default_rng(12)
    rows += [torch.as_tensor(rng.choice(lens, B).astype(np.int32))
             for _ in range(4)]
    for lens_t in rows:
        ml, acc = fdk.split_plain(q, k, v, lens_t)
        torch.testing.assert_close(
            fdk.combine_plain(ml, acc, lens_t, S, dtype).float(),
            fdk.decode_attention_plain(q, k, v, lens_t).float(), **tol)


@pytest.mark.parametrize("cache_len", [0, -3])
def test_nonpositive_cache_len_matches_the_reference(cache_len):
    """At cache_len <= 0 the reference's -1e30 fill makes the softmax
    uniform: the mean of V over all T positions.  The port's plain versions
    (the einsum form and the split + combine pair) give it, against JAX's
    ``decode_attention``, its Pallas kernel (interpret mode) and its
    oracle, per row too."""
    rng = np.random.default_rng(13)
    B, Hkv, G, T, d = 2, 2, 3, 512, 32
    q = rng.normal(size=(B, 1, Hkv * G, d)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, d)).astype(np.float32)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v),
                                           jnp.int32(cache_len)))[:, 0]
    np.testing.assert_allclose(
        want, np.broadcast_to(v.mean(axis=1).repeat(G, axis=1), want.shape),
        **TOL)
    tq, tk, tv = (torch.as_tensor(a) for a in (q[:, 0], k, v))
    lens = torch.tensor(cache_len, dtype=torch.int32)
    np.testing.assert_allclose(fdk.decode_attention(tq, tk, tv, lens).numpy(),
                               want, **TOL)
    ml, acc = fdk.split_plain(tq, tk, tv, lens)
    np.testing.assert_allclose(
        fdk.combine_plain(ml, acc, lens, T, torch.float32).numpy(), want, **TOL)
    per_row = torch.tensor([cache_len, 100], dtype=torch.int32)
    ml, acc = fdk.split_plain(tq, tk, tv, per_row)
    got = fdk.combine_plain(ml, acc, per_row, T, torch.float32).numpy()
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(
        got[1], fdk.decode_attention(tq, tk, tv, per_row).numpy()[1], **TOL)
    for b in range(B):  # the TPU kernel's layout, (H, d) and (Hkv, S, d)
        jargs = (jnp.asarray(q[b, 0]), jnp.asarray(k[b].transpose(1, 0, 2)),
                 jnp.asarray(v[b].transpose(1, 0, 2)), jnp.int32(cache_len))
        row = fdk.flash_decode(tq[b], tk[b].permute(1, 0, 2),
                               tv[b].permute(1, 0, 2), cache_len).numpy()
        np.testing.assert_allclose(row, np.asarray(jax_fd(*jargs, block_kv=128)),
                                   **TOL)
        np.testing.assert_allclose(row, np.asarray(jref.flash_decode_ref(*jargs)),
                                   **TOL)
        np.testing.assert_allclose(row, want[b], **TOL)


def test_split_plain_reads_no_position_past_cache_len():
    """Non-finite cache entries at or past a row's length change nothing."""
    q, k, v = (torch.as_tensor(a) for a in decode_case(
        np.random.default_rng(14), 3, 2, 2, 300, 16))
    lens = torch.tensor([300, 70, 1], dtype=torch.int32)
    want = fdk.decode_attention_plain(q, k, v, lens)
    for b, n in enumerate((300, 70, 1)):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    ml, acc = fdk.split_plain(q, k, v, lens)
    got = fdk.combine_plain(ml, acc, lens, 300, torch.float32)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)


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
