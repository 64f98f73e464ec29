"""The per-probe superstep on the port's two substrates, against the JAX
package, end to end.

* ``CudaBackend(fused=False, device="cpu")`` — one block-skipping segment
  sum per h-index probe and per cnt refresh (the kernels' plain versions on
  the CPU) — against the JAX ``pallas-interpret`` backend under
  ``REPRO_PALLAS_FUSED=0`` (its per-probe ``segment_sum_active`` path);
* ``"torch"`` — the same superstep over sorted prefix sums — against the
  JAX ``"xla"`` backend.

Every ``DecompResult`` field in ``FIELDS`` and core/cnt must be equal, bit
for bit: the three algorithms on the graphs of ``test_torch_decompose``,
the warm settle, the masked settle, chunk sizes 1 and 3 and the per-pass
path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import decompose as jdecompose  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import resident as jresident  # noqa: E402
from repro.core.engine import PallasBackend, XLABackend  # noqa: E402
from repro.core.semicore import HostEngine as JHostEngine  # noqa: E402
from repro.graph import chung_lu  # noqa: E402

from repro_torch.core import (CudaBackend, HostEngine, TorchBackend,  # noqa: E402
                              decompose, resolve_backend, run_resident,
                              warm_settle)
from repro_torch.core.localcore import compute_cnt_batch  # noqa: E402
from repro_torch.interop import buffered_from, csr_from  # noqa: E402
from test_torch_decompose import (ALGORITHMS, GRAPHS, _perturbed,  # noqa: E402
                                  assert_same)

# (port backend factory, JAX backend factory) per substrate; the JAX
# pallas backend runs per probe only under REPRO_PALLAS_FUSED=0
PAIRS = {
    "cuda-perprobe": (lambda: CudaBackend(device="cpu", fused=False),
                      lambda: PallasBackend(interpret=True)),
    "torch": (lambda: TorchBackend(device="cpu"), XLABackend),
}


@pytest.fixture(autouse=True)
def _jax_per_probe(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_FUSED", "0")


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batch_decompose_matches_jax(pair, graph, algorithm):
    port, ref = PAIRS[pair]
    make, be = GRAPHS[graph]
    g = make()
    want = jdecompose(g, algorithm, "batch", block_edges=be, backend=ref())
    got = decompose(csr_from(g), algorithm, "batch", block_edges=be,
                    backend=port())
    assert_same(got, want, f"{pair} {graph}/{algorithm}")
    if pair == "torch":
        assert got.backend == "torch" and got.kernel_blocks_active == 0


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_warm_settle_matches_jax(pair):
    port, ref = PAIRS[pair]
    g = chung_lu(300, 1200, seed=5)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    bg, ni = _perturbed(g)
    want = jengine.warm_settle(JHostEngine(bg, block_edges=64), core0, ni,
                               ref())
    got = warm_settle(HostEngine(buffered_from(bg), block_edges=64), core0,
                      ni, port())
    assert want.iterations > 0
    assert_same(got, want, f"{pair} warm_settle")


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_masked_settle_matches_jax(pair):
    port, ref = PAIRS[pair]
    g = chung_lu(300, 1200, seed=5)
    bg, ni = _perturbed(g)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    warm = np.minimum(core0 + ni, bg.degrees())
    vals, seg_ptr, _ = JHostEngine(bg).planner.gather(np.arange(g.n), warm)
    cnt = compute_cnt_batch(vals, seg_ptr, warm)
    mask = np.random.default_rng(0).random(g.n) < 0.5
    want = jresident.run_resident(JHostEngine(bg, block_edges=64), "semicore*",
                                  ref(), core=warm, cnt=cnt, settle_mask=mask)
    got = run_resident(HostEngine(buffered_from(bg), block_edges=64),
                       "semicore*", port(), core=warm, cnt=cnt,
                       settle_mask=mask)
    assert want.iterations > 0
    assert_same(got, want, f"{pair} masked settle")
    np.testing.assert_array_equal(got.core[~mask], warm[~mask])


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunk_size_is_pure_scheduling(pair, chunk):
    port, ref = PAIRS[pair]
    g = chung_lu(400, 1600, seed=3)
    want = jdecompose(g, "semicore*", "batch", block_edges=64, backend=ref())
    got = decompose(csr_from(g), "semicore*", "batch", block_edges=64,
                    superstep_chunk=chunk, backend=port())
    assert_same(got, want, f"{pair} chunk={chunk}")


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_per_pass_path_matches_jax(monkeypatch, pair, algorithm):
    monkeypatch.setenv("REPRO_DEVICE_RESIDENT", "0")
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    port, ref = PAIRS[pair]
    g = chung_lu(250, 900, gamma=2.3, seed=11)
    want = jdecompose(g, algorithm, "batch", block_edges=64, backend=ref())
    got = decompose(csr_from(g), algorithm, "batch", block_edges=64,
                    backend=port())
    assert_same(got, want, f"per-pass {pair} {algorithm}")


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_per_pass_warm_settle_matches_jax(monkeypatch, pair):
    monkeypatch.setenv("REPRO_DEVICE_RESIDENT", "0")
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    port, ref = PAIRS[pair]
    g = chung_lu(300, 1200, seed=5)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    bg, ni = _perturbed(g)
    want = jengine.warm_settle(JHostEngine(bg, block_edges=64), core0, ni,
                               ref())
    got = warm_settle(HostEngine(buffered_from(bg), block_edges=64), core0,
                      ni, port())
    assert_same(got, want, f"per-pass {pair} warm_settle")


# ------------------------------------------------------- mode selection
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_argument_selects_an_equal_superstep(fused, algorithm):
    """Both supersteps of the cuda backend reach the numpy backend's result
    in every field but the kernel-block tally, which numpy does not keep."""
    g = csr_from(chung_lu(200, 800, seed=4))
    backend = CudaBackend(device="cpu", fused=fused)
    assert backend.fused is fused
    got = decompose(g, algorithm, block_edges=64, backend=backend)
    want = decompose(g, algorithm, block_edges=64, backend="numpy")
    np.testing.assert_array_equal(got.core, want.core)
    np.testing.assert_array_equal(got.cnt, want.cnt)
    assert (got.iterations, got.edge_block_reads, got.node_computations) == \
        (want.iterations, want.edge_block_reads, want.node_computations)


def test_fused_knob_selects_the_superstep():
    assert CudaBackend(device="cpu").fused is True
    assert CudaBackend(device="cpu", fused=False).fused is False
    # the plain yardstick is the fused kernels' plain version
    assert CudaBackend(device="cpu", plain=True).fused is True
    with pytest.raises(ValueError, match="plain"):
        CudaBackend(device="cpu", plain=True, fused=False)
    g = chung_lu(200, 800, seed=2)
    per_probe = decompose(csr_from(g), "semicore*", block_edges=64,
                          backend=CudaBackend(device="cpu", fused=False))
    fused = decompose(csr_from(g), "semicore*", block_edges=64, device="cpu")
    assert_same(per_probe, fused, "fused=False vs fused")


def test_torch_backend_by_name_and_seq_refusal(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
    assert isinstance(resolve_backend("torch", "cpu"), TorchBackend)
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "torch")
    assert isinstance(resolve_backend(None, "cpu"), TorchBackend)
    g = csr_from(chung_lu(100, 300, seed=1))
    with pytest.raises(ValueError, match="seq"):
        decompose(g, "semicore*", "seq", device="cpu")
    with pytest.raises(ValueError, match="seq"):
        decompose(g, "semicore*", "seq", backend="torch", device="cpu")
