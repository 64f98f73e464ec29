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
from repro_torch.kernels import fused_superstep as fsk  # noqa: E402
from repro_torch.kernels import segsum as ssk, segsum_active as ssa  # noqa: E402
from repro_torch.kernels.cases import (CASES, SEGSUM_BLOCKS,  # noqa: E402
                                       SEGSUM_DTYPES, SEGSUM_FRONTIERS,
                                       SEGSUM_TOL, SEGSUM_WIDTHS,
                                       segsum_frontier, segsum_rows,
                                       segsum_values, superstep_case)

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
