"""The port's segment sums against the JAX package's Pallas segment sums.

On the CPU the port's wrappers run the kernels' plain versions; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them.  Inputs come from numpy with a seed.  Tolerances: int32 exact;
float32 rtol 1e-5 / atol 1e-4 and bfloat16 rtol 2e-2 / atol 2e-1 (the
reference's own kernel tests), since both sum in float32 in another order.

Beside the sweeps this file pins the traps of the block-skipping sum: an
inactive row whose edges span an active and a skipped block gets its
active-block partial, the activity of a partial last block, and the block
size the engine decides activity at.  It also pins the shared h-index op
``hindex_bsearch`` against the JAX package's and against a torch copy of
the reference's single-pass ``hindex_bucketed``, which no path of the port
runs and which therefore lives here as a second oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import engine as jengine  # noqa: E402
from repro.core.resident import _sorted_segsum as j_sorted_segsum  # noqa: E402
from repro.graph import paper_example_graph  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402

from repro_torch.core import (CudaBackend, decompose, edge_ge_counts,  # noqa: E402
                              hindex_bsearch)
from repro_torch.core.resident import _sorted_segsum, build_structure  # noqa: E402
from repro_torch.core import HostEngine  # noqa: E402
from repro_torch.graph import chung_lu  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402
from repro_torch.kernels import segsum as ss, segsum_active as ssa  # noqa: E402
from repro_torch.kernels.cases import (SEGSUM_FRONTIERS, SEGSUM_TOL,  # noqa: E402
                                       segsum_frontier, segsum_rows,
                                       segsum_values)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "int32": jnp.int32}


def _both(vals, dtype):
    """The same values as a port tensor and a JAX array of ``dtype``."""
    return (torch.as_tensor(vals).to(TORCH_DTYPES[dtype]),
            jnp.asarray(vals, JAX_DTYPES[dtype]))


def _assert_close(got, want, dtype, what=""):
    got = got.to(torch.float32).numpy() if dtype == "bfloat16" \
        else got.numpy()
    want = np.asarray(want, np.float32 if dtype == "bfloat16" else None)
    if dtype == "int32":
        assert got.dtype == np.int32, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        rtol, atol = SEGSUM_TOL[dtype]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


# ------------------------------------------------------------ segment_sum
@pytest.mark.parametrize("E,D,n", [(64, 8, 10), (512, 128, 100), (1000, 16, 7),
                                   (2048, 1, 2048), (3, 4, 5), (513, 32, 40)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_sum_matches_jax(E, D, n, dtype):
    rng = np.random.default_rng(E * D + n)
    rows = np.sort(rng.integers(0, n, size=E)).astype(np.int32)
    vals = segsum_values(rng, E, D, dtype)
    tv, jv = _both(vals, dtype)
    want = jops.segment_sum(jv, jnp.asarray(rows), n, block_edges=128)
    got = ss.segment_sum(tv, torch.as_tensor(rows), n, block_edges=128)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == want.shape
    _assert_close(got, want, dtype, f"E={E} D={D} n={n}")


@pytest.mark.parametrize("D", [1, 8, 64])
def test_segment_sum_bfloat16_matches_jax(D):
    rng = np.random.default_rng(D)
    rows = np.sort(rng.integers(0, 50, size=512)).astype(np.int32)
    vals = segsum_values(rng, 512, D, "bfloat16")
    tv, jv = _both(vals, "bfloat16")
    want = jops.segment_sum(jv, jnp.asarray(rows), 50, block_edges=128)
    got = ss.segment_sum(tv, torch.as_tensor(rows), 50, block_edges=128)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, "bfloat16", f"D={D}")
    # against the float32 oracle too, as the reference's own test does
    exact = jref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(rows), 50)
    _assert_close(got, exact, "bfloat16", f"D={D} vs float32")


def test_plain_segment_sum_matches_jax_ref():
    """The plain version is an ``index_add_``: it needs no sorted rows, as
    the reference's oracle needs none."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 30, size=400).astype(np.int32)  # unsorted
    vals = rng.integers(-9, 10, size=(400, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        ss.segment_sum_plain(torch.as_tensor(vals), torch.as_tensor(rows),
                             30).numpy(),
        np.asarray(jref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(rows),
                                        30)))


def test_out_of_range_rows_are_dropped_like_the_reference():
    rows = np.array([-1, 0, 0, 2, 5, 7], np.int32)
    vals = np.arange(1, 7, dtype=np.int32)
    want = np.asarray(jref.segment_sum_ref(jnp.asarray(vals),
                                           jnp.asarray(rows), 5))
    got = ss.segment_sum(torch.as_tensor(vals), torch.as_tensor(rows), 5,
                          block_edges=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [5, 0, 4, 0, 0])


def test_segsum_is_the_localcore_count_primitive():
    """Eq. 2 neighbour counts on the paper's graph, exactly, as the
    reference's kernel test checks its kernel."""
    g = paper_example_graph()
    src, dst = g.directed_pairs()
    core = np.array([3, 3, 3, 3, 2, 2, 2, 2, 1], np.int32)
    contrib = (core[dst] >= core[src]).astype(np.int32)
    got = ss.segment_sum(torch.as_tensor(contrib),
                          torch.as_tensor(src.astype(np.int32)), g.n,
                          block_edges=64).numpy()
    want = np.asarray(jops.segment_sum(jnp.asarray(contrib),
                                       jnp.asarray(src.astype(np.int32)),
                                       g.n, block_edges=64))
    np.testing.assert_array_equal(got, want)
    for v in range(g.n):
        assert got[v] == int((core[g.neighbors(v)] >= core[v]).sum())


# ----------------------------------------------------- segment_sum_active
@pytest.mark.parametrize("block_edges", [64, 128, 512])
@pytest.mark.parametrize("dtype,D", [("int32", 1), ("float32", 8),
                                     ("bfloat16", 8)])
def test_segment_sum_active_matches_jax(block_edges, dtype, D):
    rng = np.random.default_rng(block_edges + D)
    n = 120
    rows = segsum_rows(rng, n, 1500)
    E = len(rows)
    assert E % block_edges, "E must leave a partial last block"
    vals = segsum_values(rng, E, D, dtype)
    tv, jv = _both(vals, dtype)
    for kind in SEGSUM_FRONTIERS:
        active = segsum_frontier(kind, rng, n)
        want = jops.segment_sum_active(jv, jnp.asarray(rows),
                                       jnp.asarray(active), n,
                                       block_edges=block_edges)
        got = ssa.segment_sum_active(tv, torch.as_tensor(rows),
                                     torch.as_tensor(active), n,
                                     block_edges=block_edges)
        assert got.dtype == TORCH_DTYPES[dtype]
        _assert_close(got, want, dtype, f"{kind} be={block_edges}")
        if kind == "none":
            assert not got.to(torch.float32).any()


def test_segment_sum_active_wide_rows():
    rng = np.random.default_rng(11)
    rows = segsum_rows(rng, 60, 900)
    vals = segsum_values(rng, len(rows), 128, "float32")
    active = rng.random(60) < 0.3
    want = jops.segment_sum_active(jnp.asarray(vals), jnp.asarray(rows),
                                   jnp.asarray(active), 60, block_edges=128)
    got = ssa.segment_sum_active(torch.as_tensor(vals), torch.as_tensor(rows),
                                 torch.as_tensor(active), 60,
                                 block_edges=128)
    _assert_close(got, want, "float32")


def test_inactive_row_across_a_skipped_block_gets_its_partial_sum():
    """Row 1 spans blocks 0 and 1; only row 0 (block 0) is active.  Row 1
    gets the sum of its block-0 edges: neither 0 nor its full sum."""
    be = 8
    rows = np.array([0] * 5 + [1] * 7 + [2] * 8, np.int32)  # E = 20
    vals = np.arange(1, 21, dtype=np.int32)
    active = np.array([True, False, False])
    want = np.asarray(jops.segment_sum_active(
        jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(active), 3,
        block_edges=be))
    got = ssa.segment_sum_active(torch.as_tensor(vals), torch.as_tensor(rows),
                                 torch.as_tensor(active), 3,
                                 block_edges=be).numpy()
    np.testing.assert_array_equal(got, want)
    full = vals[rows == 1].sum()
    assert got[1] == vals[5:8].sum() and 0 < got[1] < full
    assert got[2] == 0
    # the block size decides the partial: at 16 edges per block row 1 has
    # more of its edges in the active block
    wide = ssa.segment_sum_active(torch.as_tensor(vals), torch.as_tensor(rows),
                                  torch.as_tensor(active), 3,
                                  block_edges=16).numpy()
    assert wide[1] == vals[5:12].sum() != got[1]


@pytest.mark.parametrize("E", [17, 24, 40])
def test_partial_last_block_flags_match_the_padded_reference(E):
    """The reference pads E to a block multiple by repeating the last row;
    the port's flags over the exact E are the same."""
    be = 8
    rng = np.random.default_rng(E)
    n = 12
    rows = np.sort(rng.integers(0, n, size=E)).astype(np.int32)
    for last_active in (False, True):
        active = rng.random(n) < 0.2
        active[rows[-1]] = last_active
        Ep = -(-E // be) * be
        padded = np.pad(rows, (0, Ep - E), mode="edge")
        want = active[padded].reshape(-1, be).max(axis=1).astype(np.int32)
        got = ssa.block_flags(torch.as_tensor(rows), torch.as_tensor(active),
                              be)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_edges", [64, 128, 512])
@pytest.mark.parametrize("kind", SEGSUM_FRONTIERS)
def test_active_block_list_is_flatnonzero_of_the_jax_mask(block_edges, kind):
    """The flags equal the block-activity mask inside the reference's
    ``make_superstep_segsum``; the plain list holds flatnonzero of them,
    in order, then zeros, and its count."""
    import inspect

    rng = np.random.default_rng(block_edges)
    n = 120
    rows = segsum_rows(rng, n, 1500)
    active = segsum_frontier(kind, rng, n)
    apply_ = jops.make_superstep_segsum(jnp.asarray(rows), jnp.asarray(active),
                                        n, block_edges=block_edges)
    mask = np.asarray(inspect.getclosurevars(apply_).nonlocals["block_active"])
    flags, ids, count = ssa.active_blocks(torch.as_tensor(rows),
                                          torch.as_tensor(active), block_edges)
    np.testing.assert_array_equal(flags.numpy(), mask)
    on = np.flatnonzero(mask)
    assert ids.dtype == count.dtype == torch.int32
    assert ids.shape == flags.shape and tuple(count.shape) == (1,)
    assert int(count) == len(on)
    np.testing.assert_array_equal(ids[:len(on)].numpy(), on)
    assert not ids[len(on):].any()
    lid, lcount = ssa.block_list_plain(flags)
    assert torch.equal(lid, ids) and torch.equal(lcount, count)


def _at(dtype, offset: int, size: int = 64):
    """A (size,) view ``offset`` elements into a fresh tensor (whose start
    the allocator aligns to at least 16 bytes)."""
    base = torch.zeros(size + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset:offset + size]


@pytest.mark.parametrize("block_edges,want", [(512, 4), (64, 4), (4, 4),
                                              (1, 1), (2, 1), (510, 1),
                                              (513, 1)])
def test_vector_width_follows_the_block_size(block_edges, want):
    rows, vals = _at(torch.int32, 0), _at(torch.int32, 0)
    assert ss.vector_width(block_edges, rows, vals) == want
    assert ss.vector_width(block_edges, rows) == want


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 8])
def test_vector_width_follows_each_operands_alignment(dtype, offset):
    """16-byte words of rows and 4-value words of vals (8 bytes of
    bfloat16): every operand must start on a 4-element boundary."""
    rows = _at(torch.int32, 0)
    vals = _at(TORCH_DTYPES[dtype], offset)
    want = 4 if offset % 4 == 0 else 1
    assert ss.vector_width(512, rows, vals) == want
    assert ss.vector_width(512, vals, rows) == want
    assert ss.vector_width(512, _at(torch.int32, offset), _at(
        TORCH_DTYPES[dtype], 0)) == want


@pytest.mark.parametrize("kind", SEGSUM_FRONTIERS)
def test_superstep_segsum_over_the_list_matches_jax(kind):
    """``make_superstep_segsum`` (flags and list once, then the probes) and
    ``segsum_active`` given the list equal the reference at D = 1."""
    rng = np.random.default_rng(21)
    n, be = 120, 64
    rows = segsum_rows(rng, n, 1500)
    active = segsum_frontier(kind, rng, n)
    t_rows, t_act = torch.as_tensor(rows), torch.as_tensor(active)
    apply_ = ssa.make_superstep_segsum(t_rows, t_act, n, block_edges=be)
    j_apply = jops.make_superstep_segsum(jnp.asarray(rows),
                                         jnp.asarray(active), n,
                                         block_edges=be)
    flags, *blocks = ssa.active_blocks(t_rows, t_act, be)
    for probe in range(3):
        vals = segsum_values(rng, len(rows), 1, "int32")
        want = np.asarray(j_apply(jnp.asarray(vals)))
        np.testing.assert_array_equal(apply_(torch.as_tensor(vals)).numpy(),
                                      want, err_msg=f"probe {probe}")
        got = ssa.segsum_active(torch.as_tensor(vals), t_rows, flags, n, be,
                                blocks=blocks)
        np.testing.assert_array_equal(got.numpy(), want)


def test_per_probe_engine_decides_activity_at_the_accounting_block(
        monkeypatch):
    """The per-probe superstep computes block flags at the block size the
    kernel-block tally replays, min(reader block, 512)."""
    seen = []
    orig = ssa.make_superstep_segsum

    def spy(rows, node_active, num_segments, *, block_edges):
        seen.append(block_edges)
        return orig(rows, node_active, num_segments, block_edges=block_edges)

    monkeypatch.setattr(ssa, "make_superstep_segsum", spy)
    g = chung_lu(200, 800, seed=1)
    for reader_block, want in ((64, 64), (4096, 512)):
        seen.clear()
        decompose(g, "semicore*", block_edges=reader_block,
                  backend=CudaBackend(device="cpu", fused=False))
        assert seen and set(seen) == {want}


def test_rows_table_is_exact_length_and_sorted():
    g = chung_lu(300, 1000, seed=2)
    rs = build_structure(HostEngine(g).planner, torch.device("cpu"))
    assert rs.E_pad > rs.E
    rows = rs.rows()
    assert rows.dtype == torch.int32 and rows.shape == (rs.E,)
    assert rs.edge_table()[1].shape == (rs.E,)
    np.testing.assert_array_equal(rows.numpy(), g.directed_pairs()[0])
    assert rs.rows() is rows  # built once per graph version


def test_wrappers_refuse_what_the_kernels_cannot_take():
    rows = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="vals"):
        ss.segment_sum(torch.zeros(10, dtype=torch.int64), rows, 3)
    with pytest.raises(TypeError, match="rows"):
        ss.segment_sum(torch.zeros(10), rows.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum(torch.zeros(10, 2).t().contiguous().t(), rows, 3)
    with pytest.raises(ValueError, match=r"\(E,\)"):
        ss.segment_sum(torch.zeros(9), rows, 3)
    with pytest.raises(ValueError, match="block_edges"):
        ss.segment_sum(torch.zeros(10), rows, 3, block_edges=0)
    with pytest.raises(ValueError, match="flags"):
        ssa.segsum_active(torch.zeros(10), rows,
                          torch.ones(2, dtype=torch.int32), 3, block_edges=4)
    flags = torch.ones(3, dtype=torch.int32)
    for blocks in ((torch.zeros(2, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32)),
                   (torch.zeros(3, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int64)),
                   (torch.zeros(3, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32))):
        with pytest.raises(ValueError, match="blocks"):
            ssa.segsum_active(torch.zeros(10), rows, flags, 3, block_edges=4,
                              blocks=blocks)


# ------------------------------------------------------ shared h-index ops
# The reference's single-pass h-index (``repro.core.engine``), in torch ops:
# ``jax.ops.segment_max`` becomes ``scatter_reduce_(..., "amax")``.
def hindex_bucketed(nbr_vals, rows, edge_mask, c_old, owned_mask):
    """Single-pass h-index: bucketed histogram + segmented suffix counts.

    O(E + V) instead of log2(kmax) masked edge scans.  Node v owns bucket
    positions [off[v], off[v] + c_old[v]] holding the counts of
    min(nbr_vals, c_old(v)); suffix counts come from one global cumsum;
    h(v) = max k with s >= k, 0 where ``owned_mask`` is off.  Needs
    ``c_old <= degree`` (the buffer holds E + V + 1 buckets), as every core
    bound is.
    """
    V = c_old.shape[0]
    if V == 0:
        return torch.zeros_like(c_old)
    E = rows.shape[0]
    dev = c_old.device
    width = c_old.to(torch.int64) + 1
    ends = torch.cumsum(width, 0)
    off = ends - width                      # exclusive offsets
    B = E + V + 1                           # bucket-buffer bound
    capped = torch.minimum(nbr_vals, c_old[rows]).to(torch.int64)
    idx = off[rows] + capped
    if edge_mask is not None:
        idx = torch.where(edge_mask, idx, B - 1)  # masked edges -> dump slot
    hist = torch.zeros(B, dtype=torch.int32, device=dev).index_add_(
        0, idx, torch.ones(E, dtype=torch.int32, device=dev))
    g = torch.cumsum(hist, 0, dtype=torch.int32)  # inclusive prefix counts
    # every bucket position p belongs to node v_of(p), candidate k =
    # p - off[v]; s = g[end_v - 1] - g[p - 1]
    pos = torch.arange(B, dtype=torch.int64, device=dev)
    v_of = torch.searchsorted(ends, pos, right=True).clamp_(0, V - 1)
    k = pos - off[v_of]
    g_prev = torch.where(pos > 0, g[(pos - 1).clamp_(min=0)], 0)
    s = g[ends[v_of] - 1] - g_prev
    valid = (k >= 1) & (k <= c_old[v_of]) & (s >= k) & (pos < ends[-1]) \
        & owned_mask[v_of]
    return torch.zeros_like(c_old).scatter_reduce_(
        0, v_of, torch.where(valid, k, 0).to(c_old.dtype), "amax")


def _hindex_case(seed, n=60):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 30, size=n)
    deg[rng.choice(n, 5, replace=False)] = 0
    seg_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(seg_ptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    nbr_vals = rng.integers(0, 25, size=E).astype(np.int32)
    c_old = np.minimum(deg, rng.integers(0, 25, size=n)).astype(np.int32)
    edge_mask = rng.random(E) < 0.8
    owned = rng.random(n) < 0.7
    return seg_ptr, rows, nbr_vals, c_old, edge_mask, owned


@pytest.mark.parametrize("seed", range(4))
def test_hindex_ops_match_each_other_and_jax(seed):
    seg_ptr, rows, vals, c_old, mask, owned = _hindex_case(seed)
    n = len(c_old)
    probes = int(np.ceil(np.log2(int(c_old.max()) + 2)))
    t = {k: torch.as_tensor(v) for k, v in dict(
        seg_ptr=seg_ptr, rows=rows, vals=vals, c_old=c_old, mask=mask,
        owned=owned).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    t_sum = _sorted_segsum(t["seg_ptr"])
    j_sum = j_sorted_segsum(j["seg_ptr"])
    kernel_sum = lambda v, r, ns: ss.segment_sum(v, r, ns, block_edges=16)  # noqa: E731
    for m_t, m_j in ((None, jnp.ones(len(rows), bool)), (t["mask"], j["mask"])):
        bs = hindex_bsearch(t["vals"], t["rows"], m_t, t["c_old"], probes,
                            segment_sum_fn=lambda v, r, ns: t_sum(v))
        bs_k = hindex_bsearch(t["vals"], t["rows"], m_t, t["c_old"], probes,
                              segment_sum_fn=kernel_sum)
        want = jengine.hindex_bsearch(
            j["vals"], j["rows"], m_j, j["c_old"], probes,
            segment_sum_fn=lambda v, r, ns: j_sum(v))
        np.testing.assert_array_equal(bs.numpy(), np.asarray(want))
        np.testing.assert_array_equal(bs_k.numpy(), bs.numpy())
        all_owned = torch.ones(n, dtype=torch.bool)
        bk = hindex_bucketed(t["vals"], t["rows"], m_t, t["c_old"], all_owned)
        np.testing.assert_array_equal(bk.numpy(), bs.numpy())
        bk = hindex_bucketed(t["vals"], t["rows"], m_t, t["c_old"],
                             t["owned"])
        want = jengine.hindex_bucketed(j["vals"], j["rows"], m_j, j["c_old"],
                                       j["owned"])
        np.testing.assert_array_equal(bk.numpy(), np.asarray(want))
        np.testing.assert_array_equal(bk.numpy(),
                                      np.where(owned, bs.numpy(), 0))
        cnt = edge_ge_counts(t["vals"], t["rows"], m_t, bs, n,
                             segment_sum_fn=kernel_sum)
        want = jengine.edge_ge_counts(
            j["vals"], j["rows"], m_j, jnp.asarray(bs.numpy()), n,
            segment_sum_fn=lambda v, r, ns: j_sum(v))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want))


def test_paper_graph_cores_through_the_segment_sum_probes():
    """h-index by segment-sum probes reaches the paper's cores."""
    g = csr_from(paper_example_graph())
    src, dst = g.directed_pairs()
    rows = torch.as_tensor(src.astype(np.int32))
    core = torch.as_tensor(g.degrees().astype(np.int32))
    seg = lambda v, r, ns: ss.segment_sum(v, r, ns, block_edges=8)  # noqa: E731
    for _ in range(10):
        core = hindex_bsearch(core[torch.as_tensor(dst)], rows, None, core, 4,
                              segment_sum_fn=seg)
    np.testing.assert_array_equal(core.numpy(), [3, 3, 3, 3, 2, 2, 2, 2, 1])
