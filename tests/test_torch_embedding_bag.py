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


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("N,D,B,L", BAG_CASES)
def test_slot_order_sum_matches_the_jax_oracle_and_the_plain_bag(N, D, B, L,
                                                                 mode):
    """The card's bit-for-bit yardstick (unweighted bags summed slot by
    slot) against the reference's oracle and the plain version."""
    table, idx, _ = _draw(N, D, B, L)
    got = tref.embedding_bag_slot_order(torch.as_tensor(table),
                                        torch.as_tensor(idx), mode).numpy()
    oracle = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx),
        jnp.ones(idx.shape, jnp.float32), mode))
    np.testing.assert_allclose(got, oracle, **TOL)
    plain = ebk.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                              mode=mode).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


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


# ------------------------------------------------- the kernel's host rules
H100_WAVE = 132 * 2048  # SMs x threads an SM holds


def _view(shape, dtype, offset: int = 0):
    """A contiguous ``shape`` view ``offset`` elements into a fresh tensor
    (whose start the allocator aligns to at least 16 bytes)."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset:offset + n].view(shape)


@pytest.mark.parametrize("table_off,want", [
    (0, dict(vec=4, tpb=16)),
    (1, dict(vec=1, tpb=32)),
    (2, dict(vec=1, tpb=32)),
    (4, dict(vec=4, tpb=16)),
])
def test_plan_at_mind_width(table_off, want):
    """16-byte loads only where every row starts 16-byte aligned."""
    table = _view((100_000, 64), torch.float32, table_off)
    for idx_off, L in ((0, 16), (1, 16), (0, 37)):  # indices never matter
        idx = _view((8, L), torch.int32, idx_off)
        assert ebk.plan(table, idx, H100_WAVE) == dict(want, small=True)


@pytest.mark.parametrize("D,dtype,want", [
    (20, torch.float32, dict(vec=4, tpb=8)),
    (20, torch.bfloat16, dict(vec=1, tpb=32)),
    (64, torch.bfloat16, dict(vec=8, tpb=8)),
    (128, torch.float32, dict(vec=4, tpb=32)),
    (200, torch.float32, dict(vec=4, tpb=32)),
    (1, torch.float32, dict(vec=1, tpb=1)),
])
def test_plan_at_other_widths(D, dtype, want):
    got = ebk.plan(_view((10, D), dtype), _view((3, 4), torch.int32),
                   H100_WAVE)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [10, 100_000, 2_000_000])
def test_every_plan_meets_the_kernels_contract(dtype, rows):
    """What ``eb_embedding_bag`` takes of a plan, and that a bag's lanes
    cover its row, at every width 1..130, aligned and not (the table a
    stride-0 view: ``plan`` reads only its shape, dtype and address)."""
    idx = _view((2, 5), torch.int32)
    for D in range(1, 131):
        for off in (0, 1):
            table = _view((D,), dtype, off).expand(rows, D)
            p = ebk.plan(table, idx, H100_WAVE)
            vec, tpb = p["vec"], p["tpb"]
            assert vec == 1 or (vec * table.element_size() == 16
                                and D % vec == 0 and off == 0)
            assert 32 % tpb == 0 and (tpb == 32 or tpb * vec >= D)
            assert tpb == 1 or (tpb // 2) * vec < D  # the fewest lanes


@pytest.mark.parametrize("rows,D,dtype,bags,small", [
    (100_000, 64, torch.float32, 8, True),           # retrieval_cand
    (100_000, 64, torch.float32, 4_096, True),       # serve_p99
    (100_000, 64, torch.float32, 16_895, True),      # 16 lanes a bag
    (100_000, 64, torch.float32, 16_896, False),     # a whole wave
    (100_000, 64, torch.float32, 2_097_152, False),  # serve_bulk
    (200_000, 64, torch.float32, 16_895, True),      # rows never matter
    (200_000, 64, torch.float32, 16_896, False),
    (1000, 64, torch.bfloat16, 33_791, True),        # 8 lanes a bag
    (1000, 64, torch.bfloat16, 33_792, False),
    (1000, 20, torch.float32, 33_791, True),         # 8 lanes (5 live)
    (1000, 20, torch.float32, 33_792, False),
    (1000, 20, torch.bfloat16, 8_447, True),         # 32 scalar lanes
    (1000, 20, torch.bfloat16, 8_448, False),
    (1000, 1, torch.float32, 270_335, True),         # one lane a bag
    (1000, 1, torch.float32, 270_336, False),
])
def test_small_launch_is_less_than_one_wave(rows, D, dtype, bags, small):
    """``small`` picks the kernel instance with more row loads in flight
    a lane: a launch whose groups of ``tpb`` lanes a bag fill less than
    one wave of the card waits on its dependent loads, not on L2."""
    table = _view((D,), dtype).expand(rows, D)
    p = ebk.plan(table, _view((bags, 16), torch.int32), H100_WAVE)
    assert p["small"] is small
    assert (bags * p["tpb"] < H100_WAVE) is small


def test_wave_threads_reads_each_card_once(monkeypatch):
    """The card's wave is read from its properties once a device, not at
    every launch."""
    class Props:
        multi_processor_count, max_threads_per_multi_processor = 132, 2048

    reads = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: reads.append(dev) or Props())
    monkeypatch.setattr(ebk, "_WAVE", {})
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for _ in range(3):
        for dev in cards:
            assert ebk.wave_threads(dev) == H100_WAVE
    assert reads == cards


@pytest.mark.parametrize("spec,want", [
    ("shipped", dict(gather=None, N=100_000, B=2_097_152, consts={})),
    ("gather", dict(gather="gr_gather", N=100_000, B=2_097_152, consts={})),
    ("gather=row,N=25000", dict(gather="gr_row_gather", N=25_000,
                                B=2_097_152, consts={})),
    ("gather,kChunk=4,kThreads=256", dict(
        gather="gr_gather", N=100_000, B=2_097_152,
        consts={"kChunk": 4, "kThreads": 256})),
    ("B=4096,kChunkSmall=4,kMinBlocks=1", dict(
        gather=None, N=100_000, B=4096,
        consts={"kChunkSmall": 4, "kMinBlocks": 1})),
])
def test_probe_variants_parse(spec, want):
    from repro_torch.kernels import probe_embedding_bag as probe

    assert probe.parse(spec) == want


@pytest.mark.parametrize("spec", ["gather=", "gather=col", "slabs=2",
                                  "kHints=0", "N=", "shipped,B=8"])
def test_probe_refuses_unknown_variants(spec):
    from repro_torch.kernels import probe_embedding_bag as probe

    with pytest.raises(ValueError, match="none of"):
        probe.parse(spec)


@pytest.mark.parametrize("name", ["kChunk", "kChunkSmall", "kMinBlocks",
                                  "kThreads"])
def test_probe_constants_are_in_the_shipped_source(name):
    """Each constant the probe rebuilds is defined once in the kernel's
    source (and ``kChunk``, ``kThreads`` in the gather's)."""
    import re

    from repro_torch.kernels import _build

    pattern = rf"constexpr int {name} = \d+;"
    src = (_build.CSRC / "embedding_bag.cu").read_text()
    assert len(re.findall(pattern, src)) == 1
    gather = (_build.CSRC / "probe" / "gather_rows.cu").read_text()
    assert len(re.findall(pattern, gather)) == (name in ("kChunk",
                                                         "kThreads"))
