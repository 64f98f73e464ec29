"""The port's EmbeddingBag (plain version, on the CPU) against the JAX
package's Pallas kernel (interpret mode) and its oracle.

Tolerances: rtol/atol 1e-5 in float32, the reference's own kernel tests
(both sides sum in float32, in another order).  The kernel itself runs on
the card only (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import embedding_bag as jax_bag  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.cases import BAG_CASES, bag_case  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _draw(N, D, B, L):
    """The reference test's draw: normal table, idx in [-1, N), weights in
    [0.5, 2)."""
    rng = np.random.default_rng(N + B)
    table = rng.normal(size=(N, D)).astype(np.float32)
    idx = rng.integers(-1, N, size=(B, L)).astype(np.int32)
    w = rng.uniform(0.5, 2.0, size=(B, L)).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("N,D,B,L", BAG_CASES)
def test_embedding_bag_matches_jax_kernel_and_oracle(N, D, B, L, mode,
                                                     weighted):
    table, idx, w = _draw(N, D, B, L)
    jw = jnp.asarray(w) if weighted else None
    tw = torch.as_tensor(w) if weighted else None
    got = ebk.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx), tw,
                            mode=mode).numpy()
    want = np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(idx), jw,
                              mode=mode))
    np.testing.assert_allclose(got, want, **TOL)
    ones = np.ones_like(w)
    oracle = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w if weighted
                                                          else ones), mode))
    np.testing.assert_allclose(got, oracle, **TOL)
    port_oracle = tref.embedding_bag_ref(
        torch.as_tensor(table), torch.as_tensor(idx),
        torch.as_tensor(w if weighted else ones), mode).numpy()
    np.testing.assert_allclose(port_oracle, oracle, **TOL)


def test_plain_entry_point_equals_the_dispatch_on_cpu():
    table, idx, w = (torch.as_tensor(a) for a in
                     bag_case(np.random.default_rng(1), 50, 8, 6, 5))
    for mode in ("sum", "mean"):
        assert torch.equal(ebk.embedding_bag(table, idx, w, mode=mode),
                           ebk.embedding_bag_plain(table, idx, w, mode=mode))


def test_bfloat16_table_against_the_float32_oracle():
    table, idx, w = _draw(1000, 64, 8, 10)
    got = ebk.embedding_bag(torch.as_tensor(table).bfloat16(),
                            torch.as_tensor(idx), torch.as_tensor(w),
                            mode="mean")
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), "mean"))
    # bfloat16 table and weights (8 bits), one rounding of the result
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_masked_slot_adds_exactly_zero_even_over_a_non_finite_row_0():
    """A masked slot reads no row: a NaN/inf row 0 changes nothing here,
    where the reference (row 0 times weight 0) turns the bag into NaN."""
    table, idx, w = _draw(100, 16, 4, 3)
    idx[:, 0] = -1
    idx[idx == 0] = 5
    base = ebk.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                             torch.as_tensor(w))
    bad = table.copy()
    bad[0] = np.inf
    bad[0, ::2] = np.nan
    got = ebk.embedding_bag(torch.as_tensor(bad), torch.as_tensor(idx),
                            torch.as_tensor(w))
    assert torch.equal(got, base)
    assert torch.isfinite(got).all()
    jax_out = np.asarray(jax_bag(jnp.asarray(bad), jnp.asarray(idx),
                                 jnp.asarray(w)))
    assert np.isnan(jax_out).all(axis=1).all()


def test_all_masked_bag_in_mean_mode_is_zero():
    table, _, w = _draw(30, 8, 3, 4)
    idx = np.full((3, 4), -1, np.int32)
    idx[1] = [2, -1, 7, -1]
    got = ebk.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                            torch.as_tensor(w), mode="mean").numpy()
    assert (got[0] == 0).all() and (got[2] == 0).all()
    want = (w[1, 0] * table[2] + w[1, 2] * table[7]) / (w[1, 0] + w[1, 2])
    np.testing.assert_allclose(got[1], want, **TOL)


def test_wrapper_refusals():
    table = torch.zeros(10, 4)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(IndexError, match="10 rows"):
        ebk.embedding_bag(table, torch.full((2, 3), 10, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        ebk.embedding_bag(table, idx.long())
    with pytest.raises(TypeError, match="table"):
        ebk.embedding_bag(table.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        ebk.embedding_bag(torch.zeros(4, 10).t(), idx)
    with pytest.raises(ValueError, match="weights must be"):
        ebk.embedding_bag(table, idx, torch.ones(3, 2))
    with pytest.raises(ValueError, match="mode"):
        ebk.embedding_bag(table, idx, mode="max")
    with pytest.raises(ValueError, match="is on"):
        ebk.embedding_bag(table, idx.to("meta"))
