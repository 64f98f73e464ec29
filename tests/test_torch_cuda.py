"""The CUDA kernels on a GPU, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a GPU (decided in the
fixture, never at import).  The file imports torch, numpy and
``repro_torch`` only, so it runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CudaBackend, HostEngine, decompose,  # noqa: E402
                              warm_settle)
from repro_torch.core.imcore import imcore_peel  # noqa: E402
from repro_torch.graph import BufferedGraph, chung_lu  # noqa: E402
from repro_torch.kernels import fused_superstep as fsk  # noqa: E402
from repro_torch.kernels.cases import CASES, superstep_case  # noqa: E402

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


def _same(a, b, what):
    np.testing.assert_array_equal(a.core, b.core, err_msg=what)
    if b.cnt is not None:
        np.testing.assert_array_equal(a.cnt, b.cnt, err_msg=what)
    for f in FIELDS:
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
