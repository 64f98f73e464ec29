"""The CUDA kernels on a GPU, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a GPU (decided in the
fixture, never at import).  The file imports torch, numpy and
``repro_torch`` only, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CudaBackend, HostEngine, TorchBackend,  # noqa: E402
                              decompose, warm_settle)
from repro_torch.core.imcore import imcore_peel  # noqa: E402
from repro_torch.graph import BufferedGraph, chung_lu  # noqa: E402
from repro_torch.graph.differential_cases import (  # noqa: E402
    BACKINGS as DIFF_BACKINGS, FAMILIES as DIFF_FAMILIES, with_backing)
from repro_torch.graph.update_cases import FAMILIES as update_families  # noqa: E402
from repro_torch.kernels import fused_superstep as fsk  # noqa: E402
from repro_torch.kernels import segsum as ssk, segsum_active as ssa  # noqa: E402
from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.kernels.ref import embedding_bag_slot_order  # noqa: E402
from repro_torch.kernels.cases import (BAG_CASES, BAG_DTYPES,  # noqa: E402
                                       BAG_MODES, BAG_TOL, CASES,
                                       STATE_FRONTIERS, binned_case,
                                       star_case, superstep_state,
                                       DECODE_BATCH, DECODE_CASES,
                                       DECODE_DTYPES, DECODE_TOL,
                                       SEGSUM_BLOCKS, SEGSUM_DTYPES,
                                       SEGSUM_FRONTIERS, SEGSUM_TOL,
                                       SEGSUM_WIDTHS, bag_case, decode_case,
                                       decode_lens, segsum_frontier,
                                       segsum_rows, segsum_values,
                                       superstep_case)

ALGORITHMS = ("semicore", "semicore+", "semicore*")
FIELDS = ("iterations", "node_computations", "updates_per_iter",
          "computations_per_iter", "edge_block_reads", "node_table_reads",
          "kernel_blocks_active", "kernel_blocks_skipped")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cases(seed, device):
    rng = np.random.default_rng(seed)
    for (n, m, _tile, iso, frontier) in CASES:
        c = superstep_case(n, m, iso, frontier, rng)
        yield frontier, {k: torch.as_tensor(
            v.astype(np.int32) if k == "seg_ptr" else v, device=device)
            for k, v in c.items()}


def _same(a, b, what, fields=FIELDS):
    np.testing.assert_array_equal(a.core, b.core, err_msg=what)
    assert (a.cnt is None) == (b.cnt is None), what
    if b.cnt is not None:
        np.testing.assert_array_equal(a.cnt, b.cnt, err_msg=what)
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f"{what}: {f}"


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_pass_kernel_matches_plain(dev, algorithm):
    fsk.reset_launch_counts()
    for frontier, t in _cases(7, dev):
        args = (t["core"], t["cnt"], t["active"], t["seg_ptr"], t["nbr"])
        got = fsk.fused_pass(*args, algorithm=algorithm)
        want = fsk.fused_pass_plain(*args, algorithm=algorithm)
        for name, g_, w_ in zip(("core2", "cnt2", "active2", "upd"), got,
                                want):
            assert torch.equal(g_, w_), f"{algorithm}/{frontier} {name}"
    torch.cuda.synchronize(dev)
    assert fsk.LAUNCHES["row_pass"] == len(CASES)
    assert fsk.LAUNCHES["push_pass"] == \
        (0 if algorithm == "semicore" else len(CASES))


def test_hindex_and_counts_kernels_match_plain(dev):
    for frontier, t in _cases(8, dev):
        table = (t["seg_ptr"], t["nbr"])
        got = fsk.fused_hindex(t["core"], t["active"], *table)
        want = fsk.fused_hindex_plain(t["core"], t["active"], *table)
        assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want)), frontier
        got = fsk.fused_counts(t["core"], t["thr"], t["active"], *table)
        want = fsk.fused_counts_plain(t["core"], t["thr"], t["active"],
                                      *table)
        assert torch.equal(got, want), frontier


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    _, t = next(_cases(9, dev))
    table = (t["seg_ptr"], t["nbr"])
    with pytest.raises(TypeError, match="int32"):
        fsk.fused_hindex(t["core"].long(), t["active"], *table)
    with pytest.raises(ValueError, match="is on"):
        fsk.fused_hindex(t["core"], t["active"].cpu(), *table)
    with pytest.raises(ValueError, match="contiguous"):
        fsk.fused_counts(t["core"], torch.stack([t["thr"], t["thr"]], 1)[:, 0],
                         t["active"], *table)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_decompose_on_the_card_matches_plain_and_peel(dev, algorithm):
    g = chung_lu(3000, 15000, seed=3)
    fsk.reset_launch_counts()
    got = decompose(g, algorithm, block_edges=64)
    assert fsk.LAUNCHES["row_pass"] >= got.iterations
    plain = decompose(g, algorithm, block_edges=64,
                      backend=CudaBackend(device=dev, plain=True))
    _same(got, plain, algorithm)
    np.testing.assert_array_equal(got.core, imcore_peel(g))


def test_per_pass_path_on_the_card(dev, monkeypatch):
    g = chung_lu(2000, 9000, seed=4)
    resident = decompose(g, "semicore*", block_edges=64)
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    per_pass = decompose(g, "semicore*", block_edges=64)
    _same(per_pass, resident, "per-pass")


def test_warm_settle_on_the_card(dev):
    g = chung_lu(2000, 9000, seed=5)
    core0 = decompose(g, "semicore*").core
    bg = BufferedGraph(g)
    e = g.edge_list()
    for i in range(0, 300, 7):
        bg.delete_edge(*map(int, e[i]))
    ni = sum(bg.insert_edge(u, 1999 - u) for u in range(40))
    got = warm_settle(HostEngine(bg, block_edges=64), core0, ni)
    plain = warm_settle(HostEngine(bg, block_edges=64), core0, ni,
                        CudaBackend(device=dev, plain=True))
    _same(got, plain, "warm_settle")
    np.testing.assert_array_equal(got.core, imcore_peel(bg.materialize()))


# ------------------------------------------- superstep bins and frontiers
def _table(c, dev):
    return (torch.as_tensor(c["seg_ptr"].astype(np.int32), device=dev),
            torch.as_tensor(c["nbr"], device=dev))


def _state(st, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in st.items()}


def _every_mode_matches_plain(table, t, what):
    """fused_pass (3 algorithms), fused_hindex and fused_counts against
    their plain versions, bit for bit; a plan built once is shared."""
    plan = fsk.bin_plan(table[0])
    args = (t["core"], t["cnt"], t["active"], *table)
    for algo in ALGORITHMS:
        got = fsk.fused_pass(*args, algorithm=algo, plan=plan)
        want = fsk.fused_pass_plain(*args, algorithm=algo)
        for name, g_, w_ in zip(("core2", "cnt2", "active2", "upd"), got,
                                want):
            assert torch.equal(g_, w_), f"{what} {algo} {name}"
    got = fsk.fused_hindex(t["core"], t["active"], *table)
    want = fsk.fused_hindex_plain(t["core"], t["active"], *table)
    for name, g_, w_ in zip(("h", "cnt_at_h"), got, want):
        assert torch.equal(g_, w_), f"{what} hindex {name}"
    got = fsk.fused_counts(t["core"], t["thr"], t["active"], *table,
                           plan=plan)
    want = fsk.fused_counts_plain(t["core"], t["thr"], t["active"], *table)
    assert torch.equal(got, want), f"{what} counts"


@pytest.mark.parametrize("cores", ["degree", "random"])
@pytest.mark.parametrize("frontier", STATE_FRONTIERS)
def test_bins_match_plain_at_every_boundary(dev, frontier, cores):
    """A row at each bin boundary -1, at and +1 (and degree 0), every
    mode; with the degrees as cores the two bin-3 rows take the probe
    loop (cap >= HIST_BINS), with random cores the histogram."""
    rng = np.random.default_rng(11)
    c = binned_case(rng)
    table = _table(c, dev)
    t = _state(superstep_state(c["seg_ptr"], frontier, cores, rng), dev)
    fsk.reset_launch_counts()
    _every_mode_matches_plain(table, t, f"{frontier}/{cores}")
    torch.cuda.synchronize(dev)
    assert fsk.LAUNCHES["row_pass"] == 5
    assert fsk.LAUNCHES["push_pass"] == 2


@pytest.mark.parametrize("frontier", ["one", "all", "rand"])
def test_star_hub_past_the_shared_histogram(dev, frontier):
    """A hub of 100,000 leaves (bin 3, always on the frontier) whose cap
    and h both exceed the shared histogram: its leaves' cores are uniform
    in [0, 20,000), so h is about 16,700; the leaves fill bin 0."""
    rng = np.random.default_rng(12)
    c = star_case(rng)
    table = _table(c, dev)
    st = superstep_state(c["seg_ptr"], frontier, "degree", rng)
    st["core"] = rng.integers(0, 20_000, size=len(st["core"])).astype(
        np.int32)
    st["core"][0] = np.diff(c["seg_ptr"])[0]
    st["active"][0] = True
    t = _state(st, dev)
    _every_mode_matches_plain(table, t, f"star/{frontier}")
    h, _ = fsk.fused_hindex(t["core"], t["active"], *table)
    assert int(h[0]) > fsk.HIST_BINS


def test_supersteps_and_upd_match_plain_until_the_frontier_empties(dev):
    """The resident loop by hand: each semicore* superstep's outputs and
    upd equal the plain version's, on to three supersteps past the empty
    frontier (what a chunk's overrun runs)."""
    g = chung_lu(3000, 15000, seed=8)
    indptr = torch.as_tensor(g.indptr.astype(np.int32), device=dev)
    nbr = torch.as_tensor(g.adj.astype(np.int32), device=dev)
    core = torch.as_tensor(g.degrees().astype(np.int32), device=dev)
    cnt = torch.zeros_like(core)
    active = core > 0
    plan = fsk.bin_plan(indptr)
    steps, empty = 0, 0
    while empty < 3:
        got = fsk.fused_pass(core, cnt, active, indptr, nbr,
                             algorithm="semicore*", plan=plan)
        want = fsk.fused_pass_plain(core, cnt, active, indptr, nbr,
                                    algorithm="semicore*")
        for name, g_, w_ in zip(("core2", "cnt2", "active2", "upd"), got,
                                want):
            assert torch.equal(g_, w_), f"superstep {steps}: {name}"
        core, cnt, active, _ = got
        empty += not bool(active.any())
        steps += 1
    np.testing.assert_array_equal(core.cpu().numpy(), imcore_peel(g))
    assert steps > 5


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_frontier_that_empties_mid_chunk(dev, algorithm):
    """One chunk of 64 supersteps outlasts the run: the supersteps past the
    empty frontier change nothing and are not counted."""
    g = chung_lu(2000, 9000, seed=9)
    fsk.reset_launch_counts()
    got = decompose(g, algorithm, block_edges=64, superstep_chunk=64)
    assert got.iterations < 64 <= fsk.LAUNCHES["row_pass"]
    plain = decompose(g, algorithm, block_edges=64, superstep_chunk=64,
                      backend=CudaBackend(device=dev, plain=True))
    _same(got, plain, f"chunk 64 {algorithm}")


def test_decompose_reads_no_edge_of_an_inactive_row(dev):
    """The fused kernels' run charges the kernel blocks of the frontier
    alone, as the per-probe kernels (which count the blocks they read) and
    the plain version do, with the same updates per superstep."""
    g = chung_lu(3000, 15000, seed=10)
    fused = decompose(g, "semicore*", block_edges=64)
    plain = decompose(g, "semicore*", block_edges=64,
                      backend=CudaBackend(device=dev, plain=True))
    ssk.reset_blocks_read()
    per_probe = decompose(g, "semicore*", block_edges=64,
                          backend=CudaBackend(device=dev, fused=False))
    for other in (plain, per_probe):
        for f in ("kernel_blocks_active", "kernel_blocks_skipped",
                  "updates_per_iter", "computations_per_iter"):
            assert getattr(fused, f) == getattr(other, f), f
    num_probes = max(1, int(np.ceil(np.log2(int(g.degrees().max()) + 2))))
    assert ssk.blocks_read(dev) == \
        (num_probes + 1) * fused.kernel_blocks_active


def test_views_off_16_bytes_are_refused(dev):
    _, t = next(_cases(14, dev))
    table = (t["seg_ptr"], t["nbr"])
    core = torch.cat([t["core"][:1], t["core"]])[1:]  # 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        fsk.fused_hindex(core, t["active"], *table)
    cnt2 = torch.cat([t["cnt"][:1], t["cnt"]])[1:]
    with pytest.raises(ValueError, match="16-byte"):
        fsk.push_pass(fsk.MODE_SEMICORE_STAR, *table, t["core"], t["core"],
                      t["active"], cnt2)


def test_plan_of_another_shape_is_refused(dev):
    _, t = next(_cases(13, dev))
    table = (t["seg_ptr"], t["nbr"])
    with pytest.raises(ValueError, match="plan"):
        fsk.fused_pass(t["core"], t["cnt"], t["active"], *table,
                       algorithm="semicore*",
                       plan=torch.zeros(3, dtype=torch.int32, device=dev))


# ------------------------------------------------------------ segment sums
def _segsum_close(got, want, dtype, what):
    rtol, atol = SEGSUM_TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if dtype == "int32":
        assert torch.equal(got, want), what
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=what)


@pytest.mark.parametrize("dtype", SEGSUM_DTYPES)
def test_segsum_kernels_match_plain(dev, dtype):
    rng = np.random.default_rng(3)
    ssk.reset_launch_counts()
    ssa.reset_launch_counts()
    n, checks = 300, 0
    for D in SEGSUM_WIDTHS:
        rows_h = segsum_rows(rng, n, 4000)
        rows = torch.as_tensor(rows_h, device=dev)
        vals = torch.as_tensor(segsum_values(rng, len(rows_h), D, dtype),
                               device=dev).to(getattr(torch, dtype))
        for be in SEGSUM_BLOCKS:
            _segsum_close(ssk.segment_sum(vals, rows, n, be),
                          ssk.segment_sum_plain(vals, rows, n, be), dtype,
                          f"segment_sum D={D} be={be}")
            for kind in SEGSUM_FRONTIERS:
                act = torch.as_tensor(segsum_frontier(kind, rng, n),
                                      device=dev)
                flags = ssa.block_flags(rows, act, be)
                assert torch.equal(flags, ssa.block_flags_plain(rows, act,
                                                                be))
                _segsum_close(
                    ssa.segsum_active(vals, rows, flags, n, be),
                    ssa.segsum_active_plain(vals, rows, flags, n, be),
                    dtype, f"segment_sum_active D={D} be={be} {kind}")
                checks += 1
    torch.cuda.synchronize(dev)
    assert ssk.LAUNCHES["segment_sum"] == len(SEGSUM_WIDTHS) * \
        len(SEGSUM_BLOCKS)
    assert ssa.LAUNCHES["segment_sum_active"] == \
        ssa.LAUNCHES["block_flags"] == checks


def test_segsum_kernel_reads_only_active_blocks(dev):
    be, n = 64, 200
    rng = np.random.default_rng(4)
    rows = torch.as_tensor(segsum_rows(rng, n, 3000), device=dev)
    vals = torch.ones(rows.shape[0], dtype=torch.int32, device=dev)
    act = torch.as_tensor(segsum_frontier("prefix", rng, n), device=dev)
    flags = ssa.block_flags(rows, act, be)
    ssk.reset_blocks_read()
    ssa.segsum_active(vals, rows, flags, n, be)
    assert ssk.blocks_read(dev) == int(flags.sum())
    ssk.segment_sum(vals, rows, n, be)
    assert ssk.blocks_read(dev) == int(flags.sum()) + flags.shape[0]


def test_segsum_wrapper_refuses_what_the_kernel_cannot_take(dev):
    rows = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="vals"):
        ssk.segment_sum(torch.zeros(8, dtype=torch.float64, device=dev),
                        rows, 2)
    with pytest.raises(ValueError, match="is on"):
        ssk.segment_sum(torch.zeros(8, device=dev), rows.cpu(), 2)
    with pytest.raises(ValueError, match="flags"):
        ssa.segsum_active(torch.zeros(8, device=dev), rows,
                          torch.ones(1, dtype=torch.int32, device=dev), 2,
                          block_edges=4)


def _d1_case(seed, dtype, be, kind, dev, n=300, E=4001):
    """Seeded D = 1 operands (rows longer than a block, empty rows, at most
    E edges: 1,483 at the defaults, not a multiple of 4 or of any block
    size) and a frontier."""
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(segsum_rows(rng, n, E), device=dev)
    vals = torch.as_tensor(segsum_values(rng, rows.shape[0], 1, dtype),
                           device=dev).to(getattr(torch, dtype))
    act = torch.as_tensor(segsum_frontier(kind, rng, n), device=dev)
    return n, rows, vals, act


def _listed(ids, count):
    return torch.sort(ids[:int(count.item())]).values


@pytest.mark.parametrize("kind", SEGSUM_FRONTIERS)
@pytest.mark.parametrize("be", SEGSUM_BLOCKS)
@pytest.mark.parametrize("dtype", SEGSUM_DTYPES)
def test_segsum_d1_kernel_matches_plain(dev, dtype, be, kind):
    """The D = 1 warp kernel by each route (the list, the flags alone,
    every block) against the plain versions; the list against
    ``block_list_plain``; the read counter against the list's count."""
    n, rows, vals, act = _d1_case(7, dtype, be, kind, dev)
    assert rows.shape[0] % 4 and ssk.vector_width(be, rows, vals) == 4
    flags, ids, count = ssa.active_blocks(rows, act, be)
    assert torch.equal(flags, ssa.block_flags_plain(rows, act, be))
    want_ids, want_count = ssa.block_list_plain(flags)
    assert torch.equal(count, want_count)
    assert torch.equal(_listed(ids, count), want_ids[:int(want_count)])
    want = ssa.segsum_active_plain(vals, rows, flags, n, be)
    for blocks in ((ids, count), None):
        ssk.reset_blocks_read()
        _segsum_close(ssa.segsum_active(vals, rows, flags, n, be,
                                        blocks=blocks), want, dtype,
                      f"segment_sum_active {kind} blocks={blocks is not None}")
        assert ssk.blocks_read(dev) == int(count.item())
    ssk.reset_blocks_read()
    _segsum_close(ssk.segment_sum(vals, rows, n, be),
                  ssk.segment_sum_plain(vals, rows, n, be), dtype,
                  "segment_sum")
    assert ssk.blocks_read(dev) == flags.shape[0]


def test_segsum_row_across_three_blocks_with_the_middle_skipped(dev):
    """Row 1 spans blocks 0-3 (64 edges each).  With block 1 skipped it
    gets the sum of its edges in blocks 0, 2 and 3; with rows 0 and 2
    active (blocks 0 and 3), of its edges in blocks 0 and 3."""
    be = 64
    rows_h = np.array([0] * 10 + [1] * 230 + [2] * 16, np.int32)  # E = 256
    rows = torch.as_tensor(rows_h, device=dev)
    vals = torch.arange(1, 257, dtype=torch.int32, device=dev)
    flags = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    ids, count = ssa.block_list_plain(flags)
    got = ssa.segsum_active(vals, rows, flags, 3, be, blocks=(ids, count))
    keep = np.repeat([True, False, True, True], be)
    v = np.arange(1, 257)
    want = [v[(rows_h == r) & keep].sum() for r in range(3)]
    assert got.cpu().tolist() == want
    assert torch.equal(got, ssa.segsum_active_plain(vals, rows, flags, 3, be))
    # the same through the kernel's own flags: row 0 active covers block 0,
    # row 2 blocks 3 only, so row 1 keeps blocks 0 and 3
    act = torch.tensor([True, False, True], device=dev)
    flags2, ids2, count2 = ssa.active_blocks(rows, act, be)
    assert flags2.cpu().tolist() == [1, 0, 0, 1] and int(count2) == 2
    assert torch.equal(
        ssa.segsum_active(vals, rows, flags2, 3, be, blocks=(ids2, count2)),
        ssa.segsum_active_plain(vals, rows, flags2, 3, be))


@pytest.mark.parametrize("E", [1, 2, 3, 5, 63, 127, 129, 130, 515])
@pytest.mark.parametrize("dtype", SEGSUM_DTYPES)
def test_segsum_d1_below_a_block_and_off_multiples_of_4(dev, dtype, E):
    for be in (512, 64, 3):
        n, rows, vals, act = _d1_case(E, dtype, be, "sparse", dev, n=200,
                                      E=E)
        assert rows.shape[0] == E
        act[rows[0]] = True
        flags, ids, count = ssa.active_blocks(rows, act, be)
        assert torch.equal(flags, ssa.block_flags_plain(rows, act, be))
        _segsum_close(ssa.segsum_active(vals, rows, flags, n, be,
                                        blocks=(ids, count)),
                      ssa.segsum_active_plain(vals, rows, flags, n, be),
                      dtype, f"E={E} be={be}")
        _segsum_close(ssk.segment_sum(vals, rows, n, be),
                      ssk.segment_sum_plain(vals, rows, n, be), dtype,
                      f"E={E} be={be}")


@pytest.mark.parametrize("rows_off,vals_off", [(1, 0), (0, 1), (2, 3),
                                               (4, 4), (0, 2)])
@pytest.mark.parametrize("dtype", SEGSUM_DTYPES)
def test_segsum_d1_views_off_16_bytes(dev, dtype, rows_off, vals_off):
    """Views whose start is off a 16-byte boundary take the scalar
    layout and give the same sums."""
    n, rows0, vals0, act = _d1_case(11, dtype, 128, "prefix", dev)
    E = rows0.shape[0] - 8
    rows_buf = torch.zeros(E + 8, dtype=torch.int32, device=dev)
    vals_buf = torch.zeros(E + 8, dtype=vals0.dtype, device=dev)
    rows = rows_buf[rows_off:rows_off + E]
    vals = vals_buf[vals_off:vals_off + E]
    rows.copy_(rows0[:E])
    vals.copy_(vals0[:E])
    want_vec = 4 if rows_off % 4 == 0 and vals_off % 4 == 0 else 1
    assert ssk.vector_width(128, rows, vals) == want_vec
    flags, ids, count = ssa.active_blocks(rows, act, 128)
    assert torch.equal(flags, ssa.block_flags_plain(rows, act, 128))
    _segsum_close(ssa.segsum_active(vals, rows, flags, n, 128,
                                    blocks=(ids, count)),
                  ssa.segsum_active_plain(vals, rows, flags, n, 128), dtype,
                  f"offsets {rows_off} {vals_off}")
    _segsum_close(ssk.segment_sum(vals, rows, n, 128),
                  ssk.segment_sum_plain(vals, rows, n, 128), dtype,
                  f"offsets {rows_off} {vals_off}")


def test_segsum_all_flags_zero_reads_nothing(dev):
    n, rows, vals, act = _d1_case(12, "int32", 64, "none", dev)
    flags, ids, count = ssa.active_blocks(rows, act, 64)
    assert not flags.any() and int(count) == 0
    ssk.reset_blocks_read()
    before = ssk.blocks_read(dev)
    out = ssa.segsum_active(vals, rows, flags, n, 64, blocks=(ids, count))
    assert not out.any()
    out = ssa.segsum_active(vals, rows, flags, n, 64)
    assert not out.any()
    assert ssk.blocks_read(dev) == before == 0


def test_segsum_counter_grows_by_the_lists_count_each_launch(dev):
    n, rows, vals, _ = _d1_case(13, "int32", 64, "all", dev)
    rng = np.random.default_rng(13)
    ssk.reset_blocks_read()
    total = 0
    for kind in ("sparse", "prefix", "all", "none", "sparse"):
        act = torch.as_tensor(segsum_frontier(kind, rng, n), device=dev)
        apply_ = ssa.make_superstep_segsum(rows, act, n, block_edges=64)
        flags, ids, count = ssa.active_blocks(rows, act, 64)
        for _ in range(3):
            apply_(vals)
            total += int(count.item())
            assert ssk.blocks_read(dev) == total, kind


def test_segsum_int32_sums_equal_across_launches(dev):
    n, rows, vals, act = _d1_case(14, "int32", 512, "sparse", dev,
                                  n=100_000, E=200_003)
    assert rows.shape[0] == 200_003
    apply_ = ssa.make_superstep_segsum(rows, act, n, block_edges=512)
    first = apply_(vals)
    whole = ssk.segment_sum(vals, rows, n)
    for _ in range(5):
        assert torch.equal(apply_(vals), first)
        assert torch.equal(ssk.segment_sum(vals, rows, n), whole)


def test_segsum_float32_d1_stays_within_tolerance_across_launches(dev):
    """A pinned divergence: the reference's sums are deterministic (each
    block's one-hot matmul, then its window scatter, in block order,
    ``repro/kernels/segsum_active.py`` and ``ops.make_superstep_segsum``);
    the kernel adds the runs of a block's first and last rows with float
    atomics, in an order that may change from launch to launch.  Every
    launch stays within ``SEGSUM_TOL`` of the plain version."""
    n, rows, vals, act = _d1_case(15, "float32", 64, "all", dev, n=100_000,
                                  E=200_003)
    assert rows.shape[0] == 200_003
    flags, ids, count = ssa.active_blocks(rows, act, 64)
    want = ssa.segsum_active_plain(vals, rows, flags, n, 64)
    for _ in range(10):
        _segsum_close(ssa.segsum_active(vals, rows, flags, n, 64,
                                        blocks=(ids, count)), want,
                      "float32", "repeated launch")
        _segsum_close(ssk.segment_sum(vals, rows, n, 64), want, "float32",
                      "repeated launch")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_per_probe_and_torch_on_the_card_match_fused(dev, algorithm):
    g = chung_lu(3000, 15000, seed=3)
    fused = decompose(g, algorithm, block_edges=64)
    ssa.reset_launch_counts()
    per_probe = decompose(g, algorithm, block_edges=64,
                          backend=CudaBackend(device=dev, fused=False))
    assert ssa.LAUNCHES["segment_sum_active"] > per_probe.iterations
    _same(per_probe, fused, f"per-probe {algorithm}")
    plain_torch = decompose(g, algorithm, block_edges=64,
                            backend=TorchBackend(device=dev))
    _same(plain_torch, fused, f"torch {algorithm}", FIELDS[:-2])
    assert plain_torch.kernel_blocks_active == 0


def test_block_read_counter_formula(dev):
    """Each per-probe semicore* pass launches num_probes h-index probes and
    one count over the same flags, so the kernel reads (num_probes + 1)
    times the pass's active blocks."""
    g = chung_lu(2000, 9000, seed=6)
    num_probes = max(1, int(np.ceil(np.log2(int(g.degrees().max()) + 2))))
    ssk.reset_blocks_read()
    r = decompose(g, "semicore*", block_edges=64,
                  backend=CudaBackend(device=dev, fused=False))
    assert r.kernel_blocks_active > 0
    assert ssk.blocks_read(dev) == (num_probes + 1) * r.kernel_blocks_active


def test_segment_sum_reproduces_the_final_cnt(dev):
    g = chung_lu(2000, 9000, seed=7)
    r = decompose(g, "semicore*")
    src, dst = g.directed_pairs()
    core = torch.as_tensor(r.core.astype(np.int32), device=dev)
    rows = torch.as_tensor(src.astype(np.int32), device=dev)
    nbr = torch.as_tensor(dst.astype(np.int32), device=dev)
    cnt = ssk.segment_sum((core[nbr] >= core[rows]).to(torch.int32), rows,
                          g.n)
    np.testing.assert_array_equal(cnt.cpu().numpy(), r.cnt)


def test_per_probe_warm_settle_on_the_card(dev):
    g = chung_lu(2000, 9000, seed=5)
    core0 = decompose(g, "semicore*").core
    bg = BufferedGraph(g)
    e = g.edge_list()
    for i in range(0, 300, 7):
        bg.delete_edge(*map(int, e[i]))
    ni = sum(bg.insert_edge(u, 1999 - u) for u in range(40))
    fused = warm_settle(HostEngine(bg, block_edges=64), core0, ni)
    per_probe = warm_settle(HostEngine(bg, block_edges=64), core0, ni,
                            CudaBackend(device=dev, fused=False))
    _same(per_probe, fused, "per-probe warm_settle")
    plain_torch = warm_settle(HostEngine(bg, block_edges=64), core0, ni,
                              TorchBackend(device=dev))
    _same(plain_torch, fused, "torch warm_settle", FIELDS[:-2])


# ------------------------------------------------------------ maintenance
def _masked_state(g, seed):
    """A grouped-settle state on ``g`` plus 8 isolated nodes: a warm upper
    bound (cores raised, isolated nodes given a core above 0, as the
    peeled warm states can), cnt exact w.r.t. it, a random mask that
    takes in every isolated node."""
    from repro_torch.core.localcore import compute_cnt_batch

    g = type(g).from_edges(g.n + 8, g.edge_list())
    rng = np.random.default_rng(seed)
    core0 = decompose(g, "semicore*").core
    warm = np.minimum(core0 + rng.integers(0, 3, g.n), g.degrees())
    warm[-8:] = rng.integers(1, 4, 8)
    vals, seg_ptr, _ = HostEngine(g).planner.gather(np.arange(g.n), warm)
    cnt = compute_cnt_batch(vals, seg_ptr, warm)
    mask = rng.random(g.n) < 0.5
    mask[-8:] = True
    return g, warm, cnt, mask


@pytest.mark.parametrize("fused", [True, False])
def test_masked_settle_on_the_card_matches_plain(dev, fused):
    from repro_torch.core import run_resident

    g, warm, cnt, mask = _masked_state(chung_lu(3000, 15000, seed=6), 6)
    fsk.reset_launch_counts()
    ssa.reset_launch_counts()
    got = run_resident(HostEngine(g, block_edges=64), "semicore*",
                       CudaBackend(device=dev, fused=fused), core=warm,
                       cnt=cnt, settle_mask=mask)
    launched = (fsk.LAUNCHES["push_pass"] if fused
                else ssa.LAUNCHES["segment_sum_active"])
    assert got.iterations > 0 and launched > 0
    plain = run_resident(HostEngine(g, block_edges=64), "semicore*",
                         CudaBackend(device=dev, plain=True), core=warm,
                         cnt=cnt, settle_mask=mask)
    if fused:
        _same(got, plain, "masked settle")
    else:
        # a row without edges that drops counts as an update per probe (as
        # on the reference's xla backend) and not in the fused kernels (as
        # in its Pallas kernel): per probe holds every other field to the
        # plain version and its update counts to torch's
        _same(got, plain, "masked settle per probe",
              [f for f in FIELDS if f != "updates_per_iter"])
        ref = run_resident(HostEngine(g, block_edges=64), "semicore*",
                           TorchBackend(device=dev), core=warm, cnt=cnt,
                           settle_mask=mask)
        assert got.updates_per_iter == ref.updates_per_iter
        assert sum(got.updates_per_iter) == sum(plain.updates_per_iter) + 8
    # frozen nodes keep their core; the isolated ones drop to 0
    np.testing.assert_array_equal(got.core[~mask], warm[~mask])
    np.testing.assert_array_equal(got.core[-8:], 0)


def _maint_legs(dev):
    return {"cuda": "cuda", "per_probe": CudaBackend(device=dev, fused=False),
            "torch": TorchBackend(device=dev),
            "plain": CudaBackend(device=dev, plain=True)}


@pytest.mark.parametrize("family", sorted(update_families))
def test_maintenance_on_the_card_matches_plain_and_oracle(dev, family):
    from repro_torch.core import CoreMaintainer, UpdateBatch
    from repro_torch.runtime import Settings

    g = chung_lu(20000, 100000, seed=7)
    r = decompose(g, "semicore*")
    batches = [UpdateBatch.from_wire(b) for b in
               update_families[family](g, np.random.default_rng(29), r.core)]
    oracle = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt),
                            settings=Settings(backend="numpy",
                                              parallel_maint=False))
    for b in batches:
        oracle.apply(b)
    for label, backend in _maint_legs(dev).items():
        m = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt),
                           backend=backend, device=dev)
        stats = [m.apply(b) for b in batches]
        assert all(s.algorithm.startswith("parallel(") for s in stats)
        np.testing.assert_array_equal(m.core, oracle.core, err_msg=label)
        np.testing.assert_array_equal(m.cnt, oracle.cnt, err_msg=label)
    np.testing.assert_array_equal(oracle.core,
                                  imcore_peel(oracle.bg.materialize()))


def test_maintenance_kernels_launch_on_the_card(dev):
    """Over the families, the fused leg launches the superstep pair and the
    per-probe leg the segment sums; the serial leg runs warm_settle."""
    from repro_torch.core import CoreMaintainer, UpdateBatch
    from repro_torch.runtime import Settings

    g = chung_lu(20000, 100000, seed=8)
    r = decompose(g, "semicore*")
    fams = [UpdateBatch.from_wire(b) for name in ("delete_sparse",
                                                  "cascade_delete")
            for b in update_families[name](g, np.random.default_rng(3),
                                           r.core)]
    for backend, names in (("cuda", ("row_pass", "push_pass")),
                           (CudaBackend(device=dev, fused=False),
                            ("block_flags", "segment_sum_active"))):
        fsk.reset_launch_counts()
        ssa.reset_launch_counts()
        m = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt),
                           backend=backend, device=dev)
        for b in fams:
            m.apply(b)
        launches = {**fsk.LAUNCHES, **ssa.LAUNCHES}
        assert all(launches[k] > 0 for k in names), launches
    serial = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt),
                            settings=Settings(parallel_maint=False),
                            device=dev)
    for b in fams:
        assert serial.apply(b).algorithm == "batch-settle(cuda)"
    np.testing.assert_array_equal(serial.core, m.core)
    np.testing.assert_array_equal(serial.cnt, m.cnt)


def test_noop_batch_on_the_card_rebuilds_no_structure(dev):
    from repro_torch.core import CoreMaintainer, Delete, Insert, UpdateBatch

    g = chung_lu(20000, 100000, seed=9)
    r = decompose(g, "semicore*")
    m = CoreMaintainer(BufferedGraph(g), state=(r.core, r.cnt), device=dev)
    gone = [tuple(map(int, e)) for e in g.edge_list()[:50]]
    m.apply(UpdateBatch([Delete(*e) for e in gone]))
    warm_settle(m.engine, m.core, 0, m.backend)  # binds this version
    version, builds = m.bg.version, m.backend.structure_builds
    s = m.apply(UpdateBatch([Delete(*e) for e in gone]))
    assert s.num_noops == 50 and m.bg.version == version
    again = warm_settle(m.engine, m.core, 0, m.backend)
    assert m.backend.structure_builds == builds
    np.testing.assert_array_equal(again.core, m.core)
    m.apply(UpdateBatch([Insert(*e) for e in gone]))
    np.testing.assert_array_equal(m.core, r.core)
    np.testing.assert_array_equal(m.cnt, r.cnt)


# ------------------------------------------------- out-of-core (memmapped)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_probe"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_memmapped_build_decomposes_on_the_card(dev, tmp_path, algorithm,
                                                 fused):
    """A graph built out of core and memmap-loaded decomposes on the
    kernels exactly as its in-memory build does; so does its
    degree-relabeled build, through perm."""
    from repro_torch.graph import CSRGraph, build_csr, powerlaw_chunks

    def stream():
        return powerlaw_chunks(3000, 24_000, seed=6, chunk_edges=5000)

    build_csr(stream(), str(tmp_path / "g"), n=3000, chunk_edges=4096)
    stats = build_csr(stream(), str(tmp_path / "d"), n=3000,
                      chunk_edges=4096, relabel="degree")
    g = CSRGraph.load(str(tmp_path / "g"), mmap=True)
    assert isinstance(g.adj, np.memmap)
    mem = CSRGraph.from_edges(3000, np.concatenate(list(stream())))
    fsk.reset_launch_counts()
    ssa.reset_launch_counts()
    got = decompose(g, algorithm, block_edges=64,
                    backend=CudaBackend(device=dev, fused=fused))
    torch.cuda.synchronize(dev)
    if fused:
        assert fsk.LAUNCHES["row_pass"] > 0
    else:
        assert ssa.LAUNCHES["segment_sum_active"] > 0
    want = decompose(mem, algorithm, block_edges=64,
                     backend=CudaBackend(device=dev, fused=fused))
    _same(got, want, f"memmap {algorithm}")
    np.testing.assert_array_equal(got.core, imcore_peel(mem))
    r2 = decompose(CSRGraph.load(str(tmp_path / "d"), mmap=True), algorithm,
                   block_edges=64, backend=CudaBackend(device=dev,
                                                       fused=fused))
    np.testing.assert_array_equal(r2.core[stats.perm], got.core)
    if got.cnt is not None:
        np.testing.assert_array_equal(r2.cnt[stats.perm], got.cnt)
    assert r2.iterations == got.iterations
    assert r2.updates_per_iter == got.updates_per_iter


# ---------------------------------------------------------- embedding bag
def _close(got, want, tol, what):
    rtol, atol = tol
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=what)


@pytest.mark.parametrize("dtype", BAG_DTYPES)
def test_embedding_bag_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(5)
    ebk.reset_launch_counts()
    checks = 0
    for (N, D, B, L) in BAG_CASES:
        table, idx, w = (torch.as_tensor(a, device=dev)
                         for a in bag_case(rng, N, D, B, L))
        table = table.to(getattr(torch, dtype))
        for mode in BAG_MODES:
            for weights in (w, None):
                _close(ebk.embedding_bag(table, idx, weights, mode=mode),
                       ebk.embedding_bag_plain(table, idx, weights, mode=mode),
                       BAG_TOL[dtype], f"{dtype} {mode} N={N} D={D}")
                checks += 1
    torch.cuda.synchronize(dev)
    assert ebk.LAUNCHES["embedding_bag"] == checks


def test_embedding_bag_kernel_reads_no_masked_row(dev):
    rng = np.random.default_rng(6)
    table, idx, w = (torch.as_tensor(a, device=dev)
                     for a in bag_case(rng, 64, 32, 40, 7))
    idx[idx == 0] = 1
    idx[:, 3] = -1
    base = ebk.embedding_bag(table, idx, w, mode="mean")
    table[0] = float("nan")
    got = ebk.embedding_bag(table, idx, w, mode="mean")
    assert torch.equal(got, base) and bool(torch.isfinite(got).all())
    empty = torch.full((2, 5), -1, dtype=torch.int32, device=dev)
    assert bool((ebk.embedding_bag(table, empty, mode="mean") == 0).all())


def test_embedding_bag_wrapper_refuses_what_the_kernel_cannot_take(dev):
    table = torch.arange(40, dtype=torch.float32, device=dev).reshape(10, 4)
    idx = torch.zeros(2, 3, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        ebk.embedding_bag(table, idx.long())
    ebk.raise_bad_index(dev)  # nothing recorded yet
    # an index past the table: no row read, the slot adds nothing, and the
    # device word raises when read (not at the launch: no host sync there)
    far = idx.clone()
    far[0, 1] = 10
    got = ebk.embedding_bag(table, far)
    with pytest.raises(IndexError, match="rows"):
        ebk.raise_bad_index(dev)
    ebk.raise_bad_index(dev)  # the read cleared it
    masked = far.clone()
    masked[0, 1] = -1
    assert torch.equal(got, ebk.embedding_bag(table, masked))
    ebk.raise_bad_index(dev)
    with pytest.raises(ValueError, match="is on"):
        ebk.embedding_bag(table, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ebk.embedding_bag(torch.zeros(4, 10, device=dev).t(), idx)


def _mind_bags(dev, B, seed, N=100_000, D=64, L=16, low=-1, dtype="float32",
               offset=0):
    """A (N, D) normal table, ``offset`` elements into its buffer, and
    (B, L) int32 indices uniform in [low, N), drawn on the card."""
    gen = torch.Generator(dev).manual_seed(seed)
    buf = torch.randn(N * D + offset, generator=gen, device=dev)
    table = buf.to(getattr(torch, dtype))[offset:].view(N, D)
    idx = torch.randint(low, N, (B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    return table, idx, gen


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D,L", [(64, 16), (64, 37), (20, 7)])
@pytest.mark.parametrize("dtype", BAG_DTYPES)
def test_embedding_bag_200k_bags(dev, dtype, D, L, offset):
    """200,000 bags, more than one wave of the card (the kChunk instance),
    at MIND's width and BAG_CASES' L = 37 (several rounds of shuffles, an
    unroll remainder) and D = 20, on tables 16-byte aligned and one element
    off (scalar loads): unweighted bags bit for bit the slot-order sum
    (float32 and bfloat16: both sum in float32 in slot order and round
    once), weighted ones within BAG_TOL of the plain version."""
    table, idx, gen = _mind_bags(dev, 200_000, 7, D=D, L=L, dtype=dtype,
                                 offset=offset)
    p = ebk.card_plan(table, idx)
    wide = 16 // table.element_size()
    assert not p["small"]
    assert p["vec"] == (wide if offset == 0 and D % wide == 0 else 1)
    for mode in BAG_MODES:
        got = ebk.embedding_bag(table, idx, mode=mode)
        assert torch.equal(got, embedding_bag_slot_order(table, idx, mode)), \
            mode
    w = torch.rand(idx.shape, generator=gen, device=dev) + 0.5
    _close(ebk.embedding_bag(table, idx, w, mode="mean"),
           ebk.embedding_bag_plain(table, idx, w, mode="mean"),
           BAG_TOL[dtype], f"{dtype} weighted D={D} L={L} +{offset}")
    ebk.raise_bad_index(dev)


@pytest.mark.parametrize("bags", [1, 8, 4_096, 16_895])
@pytest.mark.parametrize("dtype", BAG_DTYPES)
def test_embedding_bag_launches_below_one_wave(dev, dtype, bags):
    """Batches of retrieval_cand's and serve_p99's sizes, and one bag
    below a wave of the card: the instance with more row loads in flight,
    bit for bit the slot-order sum like the large launches."""
    table, idx, gen = _mind_bags(dev, bags, 11, dtype=dtype)
    props = torch.cuda.get_device_properties(dev)
    small = bags * 16 < props.multi_processor_count \
        * props.max_threads_per_multi_processor
    assert ebk.card_plan(table, idx)["small"] is small
    for mode in BAG_MODES:
        assert torch.equal(ebk.embedding_bag(table, idx, mode=mode),
                           embedding_bag_slot_order(table, idx, mode)), mode
    w = torch.rand(idx.shape, generator=gen, device=dev) + 0.5
    _close(ebk.embedding_bag(table, idx, w, mode="mean"),
           ebk.embedding_bag_plain(table, idx, w, mode="mean"),
           BAG_TOL[dtype], f"{dtype} weighted, {bags} bags")


@pytest.mark.parametrize("dtype", BAG_DTYPES)
@pytest.mark.parametrize("table_off,idx_off", [(0, 0), (1, 0), (0, 1),
                                               (3, 2), (4, 4)])
def test_embedding_bag_views_off_16_bytes(dev, dtype, table_off, idx_off):
    """Table and index views 1-4 elements into their buffers: scalar row
    loads where a row may start off 16 bytes."""
    N, D, B, L = 100_000, 64, 5_000, 16
    gen = torch.Generator(dev).manual_seed(8)
    tbuf = torch.randn(N * D + 8, generator=gen, device=dev).to(
        getattr(torch, dtype))
    table = tbuf[table_off:table_off + N * D].view(N, D)
    ibuf = torch.randint(-1, N, (B * L + 8,), generator=gen, device=dev,
                         dtype=torch.int32)
    idx = ibuf[idx_off:idx_off + B * L].view(B, L)
    p = ebk.card_plan(table, idx)
    wide = 16 // table.element_size()
    assert p["vec"] == (wide if table_off % wide == 0 else 1)
    for mode in BAG_MODES:
        assert torch.equal(ebk.embedding_bag(table, idx, mode=mode),
                           embedding_bag_slot_order(table, idx, mode)), mode
    w = torch.rand(idx.shape, generator=gen, device=dev) + 0.5
    _close(ebk.embedding_bag(table, idx, w, mode="sum"),
           ebk.embedding_bag_plain(table, idx, w, mode="sum"),
           BAG_TOL[dtype], f"{dtype} table+{table_off} idx+{idx_off}")


def test_embedding_bag_index_past_the_table_on_a_large_batch(dev):
    """An index >= N among 200,000 bags: no row read, nothing added, and
    the device word set."""
    table, idx, _ = _mind_bags(dev, 200_000, 9, low=0)
    ebk.raise_bad_index(dev)
    idx[123_457, 5] = 100_000
    idx[199_999, 15] = 2 ** 31 - 1
    got = ebk.embedding_bag(table, idx, mode="mean")
    with pytest.raises(IndexError, match="rows"):
        ebk.raise_bad_index(dev)
    masked = torch.where(idx < 100_000, idx, -1)
    assert torch.equal(got, ebk.embedding_bag(table, masked, mode="mean"))
    assert torch.equal(got, embedding_bag_slot_order(table, idx, "mean"))
    ebk.raise_bad_index(dev)  # masked slots set nothing


def test_embedding_bag_reads_no_masked_row_on_a_large_batch(dev):
    """A NaN row 0 changes nothing for bags whose masked slots would read
    it in the reference."""
    table, idx, gen = _mind_bags(dev, 200_000, 10)
    idx[idx == 0] = 1
    idx[:, 3] = -1
    w = torch.rand(idx.shape, generator=gen, device=dev) + 0.5
    base = ebk.embedding_bag(table, idx, w, mode="mean")
    table[0] = float("nan")
    got = ebk.embedding_bag(table, idx, w, mode="mean")
    assert torch.equal(got, base) and bool(torch.isfinite(got).all())
    empty = torch.full((70_000, 16), -1, dtype=torch.int32, device=dev)
    assert bool((ebk.embedding_bag(table, empty, mode="mean") == 0).all())


# ------------------------------------------------------------ flash decode
def _hold_pair(q, k, v, lens, dtype, what):
    """The whole function, then each kernel alone, against the plain
    versions on the same inputs: the split on the splits the rule gives
    each row, the combine on the kernel's own partials."""
    B, T, Hkv = k.shape[:3]
    G = q.shape[1] // Hkv
    _close(fdk.decode_attention(q, k, v, lens),
           fdk.decode_attention_plain(q, k, v, lens), DECODE_TOL[dtype], what)
    ml, acc = fdk.launch_split(q, k, v, lens)
    ml_p, acc_p = fdk.split_plain(q, k, v, lens)
    for b, n in enumerate(lens.reshape(-1).expand(B).tolist()):
        ns = fdk.split_plan(n, T, B, Hkv, G)[2]
        _close(ml[b, :, :ns], ml_p[b, :, :ns], (2e-4, 2e-4), f"{what} m, l")
        _close(acc[b, :, :ns], acc_p[b, :, :ns], (2e-4, 2e-4), f"{what} acc")
    _close(fdk.launch_combine(ml, acc, lens, T, q.dtype),
           fdk.combine_plain(ml, acc, lens, T, q.dtype), DECODE_TOL[dtype],
           f"{what} combine")


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_flash_decode_kernels_match_plain(dev, dtype):
    """Every case of the reference's sweep, at one below, at and one above
    every boundary of the split rule, the sweep's own lengths, past T and
    at cache_len <= 0."""
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    fdk.reset_launch_counts()
    calls = 0
    for (Hkv, G, S, d) in DECODE_CASES:
        q, k, v = (torch.as_tensor(a, device=dev).to(dt) for a in
                   decode_case(rng, DECODE_BATCH, Hkv, G, S, d))
        bounds = fdk.split_boundaries(S, DECODE_BATCH, Hkv, G)
        for n in decode_lens(S, bounds) + (S + 5, 0, -3):
            lens = torch.tensor(n, dtype=torch.int32, device=dev)
            _hold_pair(q, k, v, lens, dtype,
                       f"{dtype} Hkv={Hkv} G={G} S={S} {n}")
            calls += 1
    torch.cuda.synchronize(dev)
    assert fdk.LAUNCHES["flash_decode"] == 2 * calls
    assert fdk.LAUNCHES["flash_decode_combine"] == 2 * calls


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
@pytest.mark.parametrize("d", [16, 128])
def test_flash_decode_kernel_at_the_rule_boundaries(dev, dtype, d):
    """Where the rule's cap is below the tile count (8 rows x 8 kv heads,
    as served: at most 4 splits of up to 4 tiles), one below, at and one
    above every boundary, at 1, T and past T, and with per-row lengths
    drawn from those."""
    B, Hkv, G, S = 8, 8, 2, 1024
    q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, dtype))
               for a in decode_case(np.random.default_rng(d), B, Hkv, G, S, d))
    lens = sorted({1, S, S + 5, *(x for b in fdk.split_boundaries(S, B, Hkv, G)
                                  for x in (b - 1, b, b + 1))})
    rng = np.random.default_rng(12)
    for n in lens:
        _hold_pair(q, k, v, torch.tensor(n, dtype=torch.int32, device=dev),
                   dtype, f"{dtype} d={d} {n}")
    for _ in range(4):
        per_row = torch.as_tensor(rng.choice(lens, B).astype(np.int32),
                                  device=dev)
        _hold_pair(q, k, v, per_row, dtype, f"{dtype} d={d} {per_row}")


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_flash_decode_kernel_at_nonpositive_cache_len(dev, dtype):
    """cache_len <= 0 gives the reference's answer, the mean of V over
    all T positions, per row too (beside a row of positive length)."""
    q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, dtype))
               for a in decode_case(np.random.default_rng(15), 2, 2, 3, 700,
                                    64))
    for lens in (torch.tensor(0, dtype=torch.int32, device=dev),
                 torch.tensor(-3, dtype=torch.int32, device=dev),
                 torch.tensor([-3, 100], dtype=torch.int32, device=dev)):
        _hold_pair(q, k, v, lens, dtype, f"{dtype} {lens.tolist()}")
    mean = v.float().mean(dim=1).repeat_interleave(3, dim=1).to(v.dtype)
    _close(fdk.decode_attention(q, k, v, torch.tensor(0, dtype=torch.int32,
                                                      device=dev)),
           mean, DECODE_TOL[dtype], "mean of V")


@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_flash_decode_kernel_in_head_groups(dev, dtype):
    """G > 16 query heads a kv head run as two head groups, each block
    reading its kv head's K and V."""
    q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, dtype))
               for a in decode_case(np.random.default_rng(16), 2, 2, 20, 300,
                                    32))
    for n in (1, 65, 299, 300):
        _hold_pair(q, k, v, torch.tensor(n, dtype=torch.int32, device=dev),
                   dtype, f"{dtype} G=20 {n}")


def test_flash_decode_reads_no_position_past_cache_len(dev):
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(a, device=dev) for a in
               decode_case(rng, 3, 2, 4, 1000, 64))
    lens = torch.tensor([1000, 300, 1], dtype=torch.int32, device=dev)
    want = fdk.decode_attention_plain(q, k, v, lens)
    for b, n in enumerate((1000, 300, 1)):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    got = fdk.decode_attention(q, k, v, lens)
    assert bool(torch.isfinite(got).all())
    _close(got, want, DECODE_TOL["float32"], "per-row lengths")


def test_flash_decode_tpu_layout_on_the_card(dev):
    from repro_torch.kernels.ref import flash_decode_ref

    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.normal(size=(8, 64)).astype(np.float32),
                        device=dev)
    k, v = (torch.as_tensor(rng.normal(size=(2, 700, 64)).astype(np.float32),
                            device=dev) for _ in range(2))
    _close(fdk.flash_decode(q, k, v, 511), flash_decode_ref(q, k, v, 511),
           DECODE_TOL["float32"], "(H, d) layout")


def test_flash_decode_wrapper_refuses_what_the_kernel_cannot_take(dev):
    q = torch.zeros(2, 4, 8, device=dev)
    k = torch.zeros(2, 16, 2, 8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        fdk.decode_attention(q, k.bfloat16(), k.bfloat16(), 3)
    with pytest.raises(ValueError, match="unit stride"):
        fdk.decode_attention(q, torch.zeros(2, 16, 2, 16, device=dev)[..., ::2],
                             k, 3)
    with pytest.raises(ValueError, match="is on"):
        fdk.decode_attention(q, k, k, torch.tensor(3, dtype=torch.int32))


def test_flash_decode_refuses_caches_the_copies_cannot_stage(dev):
    """The split stages K and V by 16-byte copies: a cache off 16-byte
    alignment, in its base or a stride, and a head size the kernel is not
    built for, are refused, never run on the plain version."""
    q = torch.zeros(2, 4, 16, device=dev)
    k = torch.zeros(2, 64, 2, 16, device=dev)
    odd = torch.zeros(2, 64, 2, 17, device=dev)[..., 1:]   # strides of 17
    shifted = torch.zeros(2 * 64 * 2 * 16 + 1, device=dev)[1:].reshape(k.shape)
    for bad in (odd, shifted):
        with pytest.raises(ValueError, match="16-byte"):
            fdk.decode_attention(q, bad, k, 3)
        with pytest.raises(ValueError, match="16-byte"):
            fdk.decode_attention(q, k, bad, 3)
    with pytest.raises(ValueError, match="takes d"):
        fdk.decode_attention(torch.zeros(2, 4, 48, device=dev),
                             torch.zeros(2, 64, 2, 48, device=dev),
                             torch.zeros(2, 64, 2, 48, device=dev), 3)
    fdk.reset_launch_counts()
    fdk.decode_attention(q, k, k, 3)
    assert fdk.LAUNCHES["flash_decode"] == 1


# ----------------------------------------------------------------- serving
def test_mind_serving_on_the_card_matches_plain(dev, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.data import RecsysSource
    from repro_torch.models import recsys as rec

    cfg = get_config("mind").reduced()
    params = rec.mind_init(cfg, torch.Generator(dev).manual_seed(0))
    batch = RecsysSource(cfg, 64, seed=1)(0)
    batch["candidate_ids"] = np.arange(cfg.n_items, dtype=np.int32)
    ebk.reset_launch_counts()
    got = rec.serve_step(params, cfg, batch)
    assert ebk.LAUNCHES["embedding_bag"] == 1
    vals, idx = rec.retrieval_step(params, cfg, batch, top_k=10)
    ebk.raise_bad_index(dev)
    monkeypatch.setattr(ebk, "embedding_bag", ebk.embedding_bag_plain)
    want = rec.serve_step(params, cfg, batch)
    _close(got, want, (1e-5, 1e-7), "mind_serve")
    vals_p, idx_p = rec.retrieval_step(params, cfg, batch, top_k=10)
    _close(vals, vals_p, (1e-5, 1e-7), "mind_retrieval values")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_serving_on_the_card_matches_plain(dev, dtype, monkeypatch):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = replace(get_config("qwen3-0.6b").reduced(),
                  dtype=getattr(torch, dtype))
    params = tfm.lm_init(cfg, torch.Generator(dev).manual_seed(0))
    prompts = TokenSource(4, 12, cfg.vocab, seed=0)(0)["tokens"]
    fdk.reset_launch_counts()
    kernel = ServeEngine(params, cfg, 4, 600, device=dev)
    plain = ServeEngine(params, cfg, 4, 600, device=dev)

    def on_plain(fn, *args):  # the engine with the plain attention in place
        with monkeypatch.context() as m:
            m.setattr(fdk, "decode_attention", fdk.decode_attention_plain)
            return fn(*args)

    lk, lp = kernel.prefill(prompts), on_plain(plain.prefill, prompts)
    assert fdk.LAUNCHES["flash_decode"] == 12 * cfg.n_layers
    tol = (2e-4, 2e-4) if dtype == "float32" else (5e-2, 5e-2)
    _close(lk, lp, tol, "prefill logits")
    tok = lk[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(6):  # teacher-forced on the kernel's tokens
        lk, lp = kernel.decode(tok), on_plain(plain.decode, tok)
        _close(lk, lp, tol, "decode logits")
        tok = lk[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    if dtype == "float32":
        _close(kernel.caches["k"], plain.caches["k"], tol, "k caches")


@pytest.mark.parametrize("G", [5, 7])
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_flash_decode_at_the_served_head_groups(dev, dtype, G):
    """(Hkv, G, d) = (8, 5, 128), Qwen3-14B's heads, and (8, 7, 128),
    Yi-34B's and Arctic's, on 8 rows as served: every length 1 .. 80 the
    MoE and Qwen3-14B phases of chip_smoke.py reach, and each boundary of
    the split rule up to T, one either side."""
    B, Hkv, d, S = 8, 8, 128, 2048
    q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, dtype))
               for a in decode_case(np.random.default_rng(G), B, Hkv, G, S,
                                    d))
    bounds = fdk.split_boundaries(S, B, Hkv, G)
    lens = sorted({*range(1, 81), S,
                   *(x for b in bounds for x in (b - 1, b, b + 1) if x <= S)})
    for n in lens:
        _hold_pair(q, k, v, torch.tensor(n, dtype=torch.int32, device=dev),
                   dtype, f"{dtype} G={G} {n}")


def _cpu_and_card(tree, dev):
    return {k: _cpu_and_card(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_moe_apply_on_the_card_matches_cpu(dev, arch):
    """The reduced MoE layer at a capacity that drops (cf 0.5), float32,
    on the card against the same call on the CPU."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import tree_init
    from repro_torch.models.transformer import _layer_slice

    cfg = get_config(arch).reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=0.5))
    p = _layer_slice(tree_init(moe.moe_param_specs(cfg, 1),
                               torch.Generator().manual_seed(0)), 0)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    aux_cpu, aux_dev = {}, {}
    want = moe.moe_apply(p, cfg, x, aux=aux_cpu)
    got = moe.moe_apply(_cpu_and_card(p, dev), cfg, x.to(dev), aux=aux_dev)
    _close(got.cpu(), want, (2e-5, 2e-5), f"{arch} moe_apply")
    _close(aux_dev["load_balance"].cpu(), aux_cpu["load_balance"],
           (2e-5, 2e-5), f"{arch} load balance")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G,d,dv", [(1, 192, 128), (2, 128, 128),
                                    (7, 128, 128)])
def test_chunked_attention_on_the_card_matches_cpu(dev, G, d, dv, causal):
    """Several chunks, a ragged last one, queries at an offset: float32
    on the card against the CPU, and bfloat16 operands within one bf16
    step of their float32 result."""
    from repro_torch.models.layers import chunked_attention

    rng = np.random.default_rng(G)
    B, S, T, Hkv = 2, 300, 700, 2
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, S, Hkv * G, d), (B, T, Hkv, d),
                             (B, T, Hkv, dv)))
    kw = dict(chunk=128, causal=causal, q_offset=T - S)
    want = chunked_attention(q, k, v, **kw)
    got = chunked_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    _close(got.cpu(), want, (2e-5, 2e-5), "chunked_attention float32")
    qb, kb, vb = (t.to(dev).bfloat16() for t in (q, k, v))
    b16 = chunked_attention(qb, kb, vb, **kw)
    f32 = chunked_attention(qb.float(), kb.float(), vb.float(), **kw)
    assert b16.dtype == torch.bfloat16
    _close(b16.float(), f32, (2 ** -7, 2 ** -7), "chunked_attention bf16")


@pytest.mark.parametrize("arch", ["qwen3-14b", "arctic-480b",
                                  "deepseek-v3-671b"])
def test_lm_serving_of_every_family_on_the_card_matches_cpu(dev, arch):
    """The reduced configs, float32: serve_prefill, the engine's prefill,
    decode steps and greedy tokens on the card (flash decode for GQA,
    the latent-cache einsum form for MLA) against the CPU on the same
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenSource
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch).reduced()
    params = tfm.lm_init(cfg, torch.Generator().manual_seed(0))
    on_dev = tfm.lm_init(cfg, torch.Generator(dev).manual_seed(0))
    on_dev.load_state_dict(params.state_dict())
    prompts = TokenSource(4, 12, cfg.vocab, seed=0)(0)["tokens"]
    tol = (2e-4, 2e-4)
    _close(tfm.serve_prefill(on_dev, cfg, torch.as_tensor(
        prompts, device=dev)).cpu(),
        tfm.serve_prefill(params, cfg, torch.as_tensor(prompts)), tol,
        f"{arch} serve_prefill")
    fdk.reset_launch_counts()
    card = ServeEngine(on_dev, cfg, 4, 40, device=dev)
    host = ServeEngine(params, cfg, 4, 40, device="cpu")
    _close(card.prefill(prompts).cpu(), host.prefill(prompts), tol,
           f"{arch} prefill logits")
    gqa = cfg.mla is None
    assert fdk.LAUNCHES["flash_decode"] == (12 * cfg.n_layers if gqa else 0)
    np.testing.assert_array_equal(card.generate(prompts[:, :4], 6),
                                  host.generate(prompts[:, :4], 6))
    for name in host.caches:
        _close(card.caches[name].cpu(), host.caches[name], tol,
               f"{arch} cache {name}")


# ----------------------------------------------------- the streaming service
def _stream_run(root, place):
    """A writer and a replica through ingest, snapshot, bootstrap, tail and
    recover on a small seeded graph, each placed by ``place()`` (the
    backend arguments); returns every (core, cnt) and every reply (value
    and watermark) in order, and each batch's update counts."""
    from repro_torch.stream import CoreReplica, CoreWriter
    from repro_torch.graph.update_cases import mixed_batch

    g = chung_lu(3000, 15000, seed=12)
    ops = mixed_batch(g, 6 * 40, seed=5)
    batches = [ops[i:i + 40] for i in range(0, len(ops), 40)]
    nodes = np.arange(0, g.n, 7)
    paths = dict(wal_path=str(root / "wal.log"),
                 snapshot_dir=str(root / "snaps"))
    seen = []

    def record(svc):
        m = svc.maintainer
        deg = svc.degeneracy()
        replies = (svc.coreness(nodes), svc.in_kcore(nodes, 3),
                   svc.top_k(25), svc.kcore_members(int(deg)), deg)
        seen.append((m.core.copy(), m.cnt.copy(),
                     [(np.asarray(x).tolist(), x.epoch) for x in replies]))

    w = CoreWriter(g, block_edges=128, snapshot_every=4, snapshot_keep=2,
                   **paths, **place())
    stats = [w.ingest(b) for b in batches[:5]]
    record(w)
    rep = CoreReplica(block_edges=128, **paths, **place())
    assert rep.last_bootstrap.replayed_batches == 1
    record(rep)
    stats.append(w.ingest(batches[5]))
    record(w)
    assert rep.sync() == 1 and rep.lag() == 0
    record(rep)
    w.close()
    w2, rs = CoreWriter.recover(block_edges=128, snapshot_keep=2, **paths,
                                **place())
    assert rs.warm_restart and rs.replayed_batches == 2 and w2.epoch == 6
    record(w2)
    np.testing.assert_array_equal(w2.maintainer.core,
                                  imcore_peel(w2.bg.materialize()))
    return seen, [(s.num_applied_deletes, s.num_applied_inserts, s.num_noops,
                   s.num_changed) for s in stats]


@pytest.mark.parametrize("leg", ("fused", "per_probe"))
def test_stream_service_on_the_card_matches_numpy(dev, tmp_path, leg):
    """Writer ingest, replica bootstrap and tail, and recovery on the
    card's "cuda" substrate (fused or per probe) equal the same run on
    numpy: every (core, cnt), reply and watermark, and the update counts;
    the superstep pair (or the segment sums) launch on the way."""
    names = (("row_pass", "push_pass") if leg == "fused"
             else ("block_flags", "segment_sum_active"))
    fsk.reset_launch_counts()
    ssa.reset_launch_counts()
    got = _stream_run(tmp_path / leg, lambda: {
        "backend": CudaBackend(device=dev, fused=leg == "fused")})
    launches = {**fsk.LAUNCHES, **ssa.LAUNCHES}
    assert all(launches[k] > 0 for k in names), launches
    want = _stream_run(tmp_path / "numpy", lambda: {"backend": "numpy"})
    assert len(got[0]) == len(want[0]) == 5
    for i, ((gc, gn, gr), (wc, wn, wr)) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(gc, wc, err_msg=f"core, step {i}")
        np.testing.assert_array_equal(gn, wn, err_msg=f"cnt, step {i}")
        assert gr == wr, f"replies, step {i}"
    assert got[1] == want[1]


def test_stream_service_defaults_to_the_card(dev, tmp_path):
    """Without backend or device the writer, its recovery and the replica
    settle with the fused kernels on cuda:0."""
    from repro_torch.stream import CoreReplica, CoreWriter

    g = chung_lu(3000, 15000, seed=13)
    paths = dict(wal_path=str(tmp_path / "wal.log"),
                 snapshot_dir=str(tmp_path / "snaps"))
    w = CoreWriter(g, **paths)
    assert w.maintainer.backend.name == "cuda"
    w.snapshot()
    fsk.reset_launch_counts()
    w.ingest([("-",) + tuple(map(int, e)) for e in g.edge_list()[:30]])
    rep = CoreReplica(**paths)
    w.close()
    w2, rs = CoreWriter.recover(**paths)
    assert fsk.LAUNCHES["row_pass"] > 0 and rs.warm_restart
    for svc in (rep, w2):
        assert svc.maintainer.backend.device == torch.device("cuda", 0)
        np.testing.assert_array_equal(svc.maintainer.core, w.maintainer.core)
        np.testing.assert_array_equal(svc.maintainer.cnt, w.maintainer.cnt)


# ------------------------------------------------------- the shard backend
SHARD_FIELDS = FIELDS[:-2] + ("num_shards", "shard_pad_edges")


def _shards(dev, S, **kw):
    from repro_torch.core import ShardedBackend

    return ShardedBackend(devices=[dev] * S, **kw)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_shard_backend_on_the_card_matches_plain_and_flat(dev, algorithm, S):
    """S shards on cuda:0 run the superstep pair on every shard, equal in
    every field to their plain versions and, but for the shard fields, to
    the flat "cuda" run."""
    g = chung_lu(20000, 100000, seed=8)
    fsk.reset_launch_counts()
    got = decompose(g, algorithm, block_edges=64, backend=_shards(dev, S))
    torch.cuda.synchronize(dev)
    assert fsk.LAUNCHES["row_pass"] >= S * got.iterations
    if algorithm != "semicore":
        assert fsk.LAUNCHES["push_pass"] >= S * got.iterations
    plain = decompose(g, algorithm, block_edges=64,
                      backend=_shards(dev, S, plain=True))
    _same(got, plain, f"shard {algorithm} S={S}", SHARD_FIELDS)
    assert got.num_shards == S
    flat = decompose(g, algorithm, block_edges=64,
                     backend=CudaBackend(device=dev))
    _same(got, flat, f"shard vs flat {algorithm} S={S}", FIELDS[:-2])
    np.testing.assert_array_equal(got.core, imcore_peel(g))


@pytest.mark.parametrize("S", [1, 3])
def test_shard_warm_settle_on_the_card_matches_plain(dev, S):
    g = chung_lu(20000, 100000, seed=9)
    core0 = decompose(g, "semicore*", backend=CudaBackend(device=dev)).core
    e = g.edge_list()

    def run(backend):
        bg = BufferedGraph(g)
        for i in range(0, 1000, 10):
            assert bg.delete_edge(*map(int, e[i]))
        return warm_settle(HostEngine(bg, block_edges=64), core0, 0, backend)

    fsk.reset_launch_counts()
    got = run(_shards(dev, S))
    assert fsk.LAUNCHES["row_pass"] > 0 and got.iterations > 0
    _same(got, run(_shards(dev, S, plain=True)), f"warm S={S}", SHARD_FIELDS)
    _same(got, run(TorchBackend(device=dev)), f"warm S={S} vs torch",
          FIELDS[:-2])


@pytest.mark.parametrize("S", [1, 4])
def test_shard_edgeless_drop_settle_counts_as_torch(dev, S):
    """An isolated node with a core above 0 drops in the masked settle: the
    shard counts it as an update (as the reference's shard and "torch"
    do), the flat fused kernels do not."""
    from repro_torch.core import run_resident

    g, warm, cnt, mask = _masked_state(chung_lu(3000, 15000, seed=6), 6)

    def run(backend):
        return run_resident(HostEngine(g, block_edges=64), "semicore*",
                            backend, core=warm, cnt=cnt, settle_mask=mask)

    fsk.reset_launch_counts()
    got = run(_shards(dev, S))
    assert fsk.LAUNCHES["push_pass"] > 0
    _same(got, run(_shards(dev, S, plain=True)), f"masked S={S}",
          SHARD_FIELDS)
    ref = run(TorchBackend(device=dev))
    _same(got, ref, f"masked S={S} vs torch", FIELDS[:-2])
    fused = run(CudaBackend(device=dev))
    assert sum(got.updates_per_iter) == sum(fused.updates_per_iter) + 8
    np.testing.assert_array_equal(got.core[-8:], 0)


def test_shard_maintainer_on_the_card_matches_plain(dev):
    from repro_torch.core import CoreMaintainer, UpdateBatch
    from repro_torch.graph.update_cases import light_batch

    g = chung_lu(20000, 100000, seed=10)
    legs = {"kernels": _shards(dev, 4), "plain": _shards(dev, 4, plain=True)}
    ms = {k: CoreMaintainer(g, block_edges=64, backend=b)
          for k, b in legs.items()}
    for ops in (light_batch(g, ms["kernels"].core, ms["kernels"].cnt, 40, 40,
                            seed=2),):
        stats = {k: m.apply(UpdateBatch.from_wire(ops))
                 for k, m in ms.items()}
        np.testing.assert_array_equal(ms["kernels"].core, ms["plain"].core)
        np.testing.assert_array_equal(ms["kernels"].cnt, ms["plain"].cnt)
        for f in ("node_computations", "iterations", "num_changed",
                  "edge_block_reads", "settle_passes", "groups"):
            assert getattr(stats["kernels"], f) == \
                getattr(stats["plain"], f), f
    np.testing.assert_array_equal(
        ms["kernels"].core, imcore_peel(ms["kernels"].bg.materialize()))


# ------------------------------------ the differential sweep on the card
@pytest.mark.parametrize("backing", DIFF_BACKINGS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("family", sorted(DIFF_FAMILIES))
def test_differential_sweep_on_the_card(dev, tmp_path, family, algorithm,
                                        backing):
    """Every family x algorithm x backing on the card's substrates — "cuda"
    fused and per probe, "torch", "shard" at S = 1 and 3 — each equal in
    every field to its plain version (the same backend on the host, which
    the CPU sweep holds to the reference; for the shards also the plain
    versions on the card) and to the BZ oracle."""
    g = DIFF_FAMILIES[family]()
    target = with_backing(g, backing, str(tmp_path))
    legs = {
        "cuda": (CudaBackend(device=dev), CudaBackend(device="cpu")),
        "per_probe": (CudaBackend(device=dev, fused=False),
                      CudaBackend(device="cpu", fused=False)),
        "torch": (TorchBackend(device=dev), TorchBackend(device="cpu")),
        "shard_1": (_shards(dev, 1), _shards(torch.device("cpu"), 1)),
        "shard_3": (_shards(dev, 3), _shards(torch.device("cpu"), 3)),
    }
    want_core = imcore_peel(g)
    for name, (card, host) in legs.items():
        what = f"{family}/{algorithm}/{backing}/{name}"
        got = decompose(target, algorithm, block_edges=64, backend=card)
        want = decompose(target, algorithm, block_edges=64, backend=host)
        fields = SHARD_FIELDS if name.startswith("shard") else FIELDS
        _same(got, want, what, fields)
        np.testing.assert_array_equal(got.core, want_core, err_msg=what)
        if name.startswith("shard"):
            plain = decompose(target, algorithm, block_edges=64,
                              backend=_shards(dev, got.num_shards,
                                              plain=True))
            _same(got, plain, what + " plain", fields)


# ----------------------------------------------------------------- training
def _hold_grads(got, want, what):
    """Each gradient leaf within 1e-4 x max|want| + 1e-6 (float32; the
    card sums in another order, the bag's backward with atomics)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        lim = 1e-4 * float(w.abs().max()) + 1e-6 if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= lim, (what, i, err, lim)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_autograd_on_the_card_matches_plain(dev, mode, weighted):
    """The bag under autograd on the card: the kernel's forward (one
    launch), the table's and the weights' gradients, against the plain
    version's on the same inputs, masked slots and slots past the table
    included (those read and receive nothing)."""
    rng = np.random.default_rng(9)
    N, D, B, L = 300, 20, 257, 7
    table = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, N + 5, (B, L)).astype(np.int32))
    idx[0] = -1
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (B, L)).astype(np.float32))
    cot = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32))
    t = table.to(dev).requires_grad_(True)
    tw = w.to(dev).requires_grad_(True) if weighted else None
    ebk.reset_launch_counts()
    out = ebk.embedding_bag(t, idx.to(dev), tw, mode=mode)
    assert ebk.LAUNCHES["embedding_bag"] == 1 and out.grad_fn is not None
    (out * cot.to(dev)).sum().backward()
    with pytest.raises(IndexError, match="index"):
        ebk.raise_bad_index(dev)
    want = ebk.bag_plain(table, idx, w if weighted else None, mode)
    _close(out.detach().cpu(), want, (1e-5, 1e-6), "bag forward")
    gt, gw = ebk.bag_backward(cot, table, idx, w if weighted else None,
                              mode, weighted)
    _close(t.grad.cpu(), gt, (1e-5, 1e-6), "bag table gradient")
    if weighted:
        _close(tw.grad.cpu(), gw, (1e-5, 1e-6), "bag weights gradient")
    masked = idx.reshape(-1)[(idx.reshape(-1) >= N) | (idx.reshape(-1) < 0)]
    assert masked.numel() > 0


@pytest.mark.parametrize("arch", ["mind", "qwen3-0.6b", "arctic-480b"])
def test_reduced_train_step_on_the_card_matches_cpu(dev, arch):
    """One train step of the reduced cell on the card against the same
    step on the CPU from the same weights: loss, every gradient leaf,
    the next step's loss; MIND's bag runs the kernel forward, Arctic's
    MoE (top-2 of 8) its checkpointed backward.  Arctic's step-0 routing
    has no near-tie: its 2nd and 3rd router probabilities lie >= 2e-5
    apart on every token, against ~1e-7 between the two devices."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.data import RecsysSource, TokenSource
    from repro_torch.launch import steps
    from repro_torch.models import recsys, transformer
    from repro_torch.models.params import tree_leaves, tree_init
    from repro_torch.optim import adamw_init

    b = steps.build_step(arch, "train_batch" if arch == "mind"
                         else "train_4k", reduced=True,
                         opt=steps.default_opt(get_config(arch), lr=3e-3))
    cfg, specs = b.static["cfg"], b.static["pspecs"]
    host = tree_init(specs, torch.Generator().manual_seed(0))
    card = tree_init(specs, torch.Generator(dev).manual_seed(0))
    card.load_state_dict(host.state_dict())
    if arch == "mind":
        src = RecsysSource(cfg, 64, seed=1)
        loss_fn = recsys.mind_train_loss

        def args(step, device):
            return ({k: torch.as_tensor(v, device=device)
                     for k, v in src(step).items()},)
    else:
        B, S = input_specs(cfg, "train_4k", reduced=True)[1]["tokens"][0]
        src = TokenSource(B, S, cfg.vocab)
        loss_fn = transformer.lm_loss

        def args(step, device):
            batch = src(step)
            return (torch.as_tensor(batch["tokens"], device=device),
                    torch.as_tensor(batch["labels"], device=device))

    ebk.reset_launch_counts()
    lc, gc = steps.value_and_grad(loss_fn, card, cfg, *args(0, dev))
    lh, gh = steps.value_and_grad(loss_fn, host, cfg, *args(0, "cpu"))
    assert ebk.LAUNCHES["embedding_bag"] == (1 if arch == "mind" else 0)
    _close(lc.cpu(), lh, (1e-5, 1e-6), f"{arch} loss")
    _hold_grads(gc, gh, arch)
    if arch == "mind":
        grads = dict(zip([n for n, _ in tree_leaves(card)], gc))
        assert float(grads["profile_embed"].abs().sum()) > 0
    out = []
    for params in (card, host):
        device = next(params.parameters()).device
        state = adamw_init(params, b.static["opt"])
        losses = [float(b.fn(params, state, *args(s, device))[2])
                  for s in (0, 1)]
        out.append(losses)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-3)


def test_moe_recompute_routes_as_the_first_pass_on_the_card(dev,
                                                            monkeypatch):
    """Reduced Arctic (top-2 of 8) on the card: each MoE layer's
    checkpointed recompute routes its tokens as its first pass did, and
    the gradients hold to the same step's without checkpointing (a
    recompute that routed otherwise would give wrong gradients with no
    error: non-reentrant checkpointing checks only tensor metadata)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import input_specs
    from repro_torch.data import TokenSource
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.params import tree_init

    cfg = get_config("arctic-480b").reduced()
    params = tree_init(transformer.lm_param_specs(cfg),
                       torch.Generator(dev).manual_seed(0))
    B, S = input_specs(cfg, "train_4k", reduced=True)[1]["tokens"][0]
    batch = TokenSource(B, S, cfg.vocab)(0)
    args = [torch.as_tensor(batch[k], device=dev) for k in ("tokens",
                                                           "labels")]
    seen, inner = [], transformer.moe_apply

    def recording(p, cfg, x, *a, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        seen.append(torch.topk(probs, cfg.moe.top_k).indices.sort(-1).values)
        return inner(p, cfg, x, *a, **kw)

    monkeypatch.setattr(transformer, "moe_apply", recording)
    loss, grads = steps.value_and_grad(transformer.lm_loss, params, cfg,
                                       *args)
    n = cfg.n_layers
    assert len(seen) == 2 * n  # n first passes, then n recomputes
    for first, again in zip(seen[:n], reversed(seen[n:])):
        assert torch.equal(first, again)
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    plain_loss, plain = steps.value_and_grad(transformer.lm_loss, params,
                                             cfg, *args)
    assert abs(float(loss) - float(plain_loss)) <= 1e-6 * abs(float(loss))
    _hold_grads(grads, plain, "arctic without checkpointing")


@pytest.mark.parametrize("G,causal", [(1, True), (2, True), (7, False)])
def test_chunked_attention_gradients_on_the_card_match_cpu(dev, G, causal):
    """The out-of-place form's forward and gradients on the card against
    the CPU (float32, several chunks, a ragged last one, an offset)."""
    from repro_torch.models.layers import chunked_attention

    rng = np.random.default_rng(G)
    B, S, T, Hkv, d, dv = 2, 200, 330, 2, 64, 48
    host = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
            .requires_grad_(True) for s in ((B, S, Hkv * G, d),
                                            (B, T, Hkv, d), (B, T, Hkv, dv))]
    card = [x.detach().to(dev).requires_grad_(True) for x in host]
    cot = torch.as_tensor(rng.normal(size=(B, S, Hkv * G, dv))
                          .astype(np.float32))
    kw = dict(chunk=64, causal=causal, q_offset=T - S)
    want = chunked_attention(*host, **kw)
    got = chunked_attention(*card, **kw)
    _close(got.detach().cpu(), want.detach(), (2e-5, 2e-5),
           "chunked_attention forward")
    (want * cot).sum().backward()
    (got * cot.to(dev)).sum().backward()
    for h, c, name in zip(host, card, "qkv"):
        _close(c.grad.cpu(), h.grad, (1e-4, 1e-5), f"d{name}")


GNN_CELLS = [(a, s) for a in ("graphsage-reddit", "gcn-cora", "schnet",
                              "egnn")
             for s in ("full_graph_sm", "minibatch_lg", "ogb_products",
                       "molecule")]


def _gnn_batch(cfg, shape):
    """The reduced cell's batch: its source's (make_source) where the
    source fits the arch, else drawn from its specs with numpy (the
    sampled cell gives the regression archs no z / pos / y)."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.train import make_source

    _, av = input_specs(cfg, shape, reduced=True)
    batch = make_source(cfg, shape, True)(0)
    if set(batch) == set(av["batch"]):
        return batch
    N, rng = av["num_nodes"], np.random.default_rng(14)
    out = {}
    for k, (shp, dtype) in av["batch"].items():
        if k in ("src", "dst"):
            out[k] = rng.integers(0, N, shp).astype(np.int32)
        elif k == "z":
            out[k] = rng.integers(1, 90, shp).astype(np.int32)
        else:
            out[k] = rng.normal(size=shp).astype(np.float32)
    return out


@pytest.mark.parametrize("arch,shape", GNN_CELLS)
def test_reduced_gnn_train_step_on_the_card_matches_cpu(dev, arch, shape):
    """The GNN train step of every reduced cell on the card against the
    same step on the CPU from the same weights and batch: the loss
    (``index_add`` sums with atomics on the card), every gradient leaf and
    the next step's loss."""
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_init
    from repro_torch.optim import adamw_init

    from repro_torch.configs import get_config

    b = steps.build_step(arch, shape, reduced=True,
                         opt=steps.default_opt(get_config(arch), lr=3e-3))
    cfg, specs, N = b.static["cfg"], b.static["pspecs"], \
        b.static["num_nodes"]
    host = tree_init(specs, torch.Generator().manual_seed(0))
    card = tree_init(specs, torch.Generator(dev).manual_seed(0))
    card.load_state_dict(host.state_dict())
    batch = _gnn_batch(cfg, shape)

    def on(device):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def loss_fn(p, bt):
        return gnn.gnn_loss(p, cfg, {**bt, "num_nodes": N})

    lc, gc = steps.value_and_grad(loss_fn, card, on(dev))
    lh, gh = steps.value_and_grad(loss_fn, host, on("cpu"))
    _close(lc.cpu(), lh, (1e-5, 1e-6), f"{arch}/{shape} loss")
    _hold_grads(gc, gh, f"{arch}/{shape}")
    out = []
    for params, device in ((card, dev), (host, "cpu")):
        state = adamw_init(params, b.static["opt"])
        out.append([float(b.fn(params, state, on(device))[2])
                    for _ in range(2)])
    np.testing.assert_allclose(out[0], out[1], rtol=1e-3)
