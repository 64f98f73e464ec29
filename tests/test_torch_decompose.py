"""The port's decomposition slice against the JAX package, end to end.

The same graphs (carried over by ``repro_torch.interop``) go through
``repro.core`` on the ``pallas-interpret`` backend and through
``repro_torch.core`` on the ``cuda`` backend with ``device="cpu"`` (the
kernels' plain versions).  Every field the slice owns must be equal:
core, cnt, iterations, per-pass histories, the planner's I/O counters and
the kernel-block tallies — for batch decompositions of all three
algorithms, the warm settle, the masked settle, the per-pass path and any
chunk size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import decompose as jdecompose  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import resident as jresident  # noqa: E402
from repro.core.engine import PallasBackend  # noqa: E402
from repro.core.semicore import HostEngine as JHostEngine  # noqa: E402
from repro.graph import (BufferedGraph as JBuffered, chung_lu,  # noqa: E402
                         erdos_renyi, paper_example_graph)

from repro_torch.core import (CudaBackend, HostEngine, decompose,  # noqa: E402
                              run_batch, run_resident, warm_settle)
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.core.localcore import compute_cnt_batch  # noqa: E402
from repro_torch.graph import BufferedGraph  # noqa: E402
from repro_torch.interop import buffered_from, csr_from, warm_state  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

ALGORITHMS = ("semicore", "semicore+", "semicore*")
FIELDS = ("iterations", "node_computations", "updates_per_iter",
          "computations_per_iter", "edge_block_reads", "node_table_reads",
          "kernel_blocks_active", "kernel_blocks_skipped")

# (name, graph factory, block_edges of the reference tests)
GRAPHS = {
    "paper": (paper_example_graph, 8),
    "chung_lu": (lambda: chung_lu(400, 1600, seed=3), 64),
    "er0": (lambda: erdos_renyi(300, 900, seed=0), 64),
    "er1": (lambda: erdos_renyi(300, 900, seed=1), 64),
}


def assert_same(got, want, what=""):
    np.testing.assert_array_equal(got.core, want.core, err_msg=what)
    assert (got.cnt is None) == (want.cnt is None), what
    if want.cnt is not None:
        np.testing.assert_array_equal(got.cnt, want.cnt, err_msg=what)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batch_decompose_matches_jax(graph, algorithm):
    make, be = GRAPHS[graph]
    g = make()
    want = jdecompose(g, algorithm, "batch", block_edges=be,
                      backend="pallas-interpret")
    got = decompose(csr_from(g), algorithm, "batch", block_edges=be,
                    backend="cuda", device="cpu")
    assert got.backend == "cuda"
    assert_same(got, want, f"{graph}/{algorithm}")


def _perturbed(g):
    """The warm-settle contract's update batch: 6 deletions, 3 insertions."""
    bg = JBuffered(g)
    e = g.edge_list()
    for i in range(6):
        assert bg.delete_edge(*map(int, e[i * 11]))
    ni = sum(bg.insert_edge(u, v) for u, v in [(1, 250), (2, 251), (3, 252)])
    return bg, ni


def test_warm_settle_matches_jax():
    g = chung_lu(300, 1200, seed=5)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    bg, ni = _perturbed(g)
    bg_port = buffered_from(bg)
    want = jengine.warm_settle(JHostEngine(bg, block_edges=64), core0, ni,
                               "pallas-interpret")
    got = warm_settle(HostEngine(bg_port, block_edges=64),
                      warm_state(core0)[0], ni, "cuda", device="cpu")
    assert_same(got, want, "warm_settle")
    np.testing.assert_array_equal(got.core, imcore_bz(bg_port.materialize()))


def test_masked_settle_matches_jax():
    """The grouped-maintenance settle: only masked nodes may be recomputed,
    frozen nodes still take push decrements."""
    g = chung_lu(300, 1200, seed=5)
    bg, ni = _perturbed(g)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    warm = np.minimum(core0 + ni, bg.degrees())
    vals, seg_ptr, _ = JHostEngine(bg).planner.gather(np.arange(g.n), warm)
    cnt = compute_cnt_batch(vals, seg_ptr, warm)  # exact w.r.t. the bound
    mask = np.random.default_rng(0).random(g.n) < 0.5
    want = jresident.run_resident(
        JHostEngine(bg, block_edges=64), "semicore*",
        PallasBackend(interpret=True), core=warm, cnt=cnt, settle_mask=mask)
    got = run_resident(
        HostEngine(buffered_from(bg), block_edges=64), "semicore*",
        CudaBackend(device="cpu"), core=warm, cnt=cnt, settle_mask=mask)
    assert want.iterations > 0
    assert_same(got, want, "masked settle")
    frozen = ~mask
    np.testing.assert_array_equal(got.core[frozen], warm[frozen])


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_per_pass_path_matches_jax(monkeypatch, algorithm):
    monkeypatch.setenv("REPRO_DEVICE_RESIDENT", "0")
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    g = chung_lu(250, 900, gamma=2.3, seed=11)
    want = jdecompose(g, algorithm, "batch", block_edges=64,
                      backend="pallas-interpret")
    got = decompose(csr_from(g), algorithm, "batch", block_edges=64,
                    device="cpu")
    assert_same(got, want, f"per-pass {algorithm}")


def test_per_pass_warm_settle_matches_jax(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_RESIDENT", "0")
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    g = chung_lu(300, 1200, seed=5)
    core0 = jdecompose(g, "semicore*", "batch", backend="numpy").core
    bg, ni = _perturbed(g)
    want = jengine.warm_settle(JHostEngine(bg, block_edges=64), core0, ni,
                               "pallas-interpret")
    got = warm_settle(HostEngine(buffered_from(bg), block_edges=64), core0,
                      ni, device="cpu")
    assert_same(got, want, "per-pass warm_settle")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_chunk_size_is_pure_scheduling(algorithm):
    """Chunks of 1 and 8 passes walk the same passes as the reference, and
    the host reads the device once per chunk."""
    g = chung_lu(400, 1600, seed=3)
    want = jdecompose(g, algorithm, "batch", block_edges=64,
                      backend="pallas-interpret")
    reg = metrics.get_registry()
    for chunk in (1, 8):
        snap = reg.snapshot()
        got = decompose(csr_from(g), algorithm, "batch", block_edges=64,
                        superstep_chunk=chunk, device="cpu")
        syncs = metrics.sum_by_name(reg.delta(snap),
                                    "repro_resident_host_syncs_total")
        assert_same(got, want, f"chunk={chunk}")
        assert syncs == -(-want.iterations // chunk)


def test_chunk_env_knob(monkeypatch):
    g = chung_lu(400, 1600, seed=3)
    reg = metrics.get_registry()
    monkeypatch.setenv("REPRO_TORCH_RESIDENT_CHUNK", "3")
    snap = reg.snapshot()
    r = decompose(csr_from(g), "semicore*", block_edges=64, device="cpu")
    assert metrics.sum_by_name(reg.delta(snap),
                               "repro_resident_host_syncs_total") == \
        -(-r.iterations // 3)
    # an explicit argument wins over the environment
    snap = reg.snapshot()
    decompose(csr_from(g), "semicore*", block_edges=64, superstep_chunk=64,
              device="cpu")
    assert metrics.sum_by_name(reg.delta(snap),
                               "repro_resident_host_syncs_total") == 1


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_decompose_settings_reach_the_run(monkeypatch, backend):
    """``decompose(g, settings=Settings(backend, resident_chunk))`` runs
    on that backend in chunks of that many passes, as the reference's
    does with its Settings; an explicit argument still wins."""
    from repro.runtime import Settings as JSettings
    from repro_torch.runtime import Settings

    for var in ("REPRO_TORCH_BACKEND", "REPRO_TORCH_RESIDENT_CHUNK",
                "REPRO_BACKEND", "REPRO_RESIDENT_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    g = chung_lu(400, 1600, seed=3)
    want = jdecompose(g, "semicore*", "batch", block_edges=64,
                      settings=JSettings(
                          backend="xla" if backend == "torch"
                          else "pallas-interpret", resident_chunk=3))
    reg = metrics.get_registry()
    snap = reg.snapshot()
    got = decompose(csr_from(g), "semicore*", "batch", block_edges=64,
                    settings=Settings(backend=backend, resident_chunk=3),
                    device="cpu")
    syncs = metrics.sum_by_name(reg.delta(snap),
                                "repro_resident_host_syncs_total")
    assert got.backend == backend
    assert syncs == -(-want.iterations // 3)
    assert_same(got, want, backend)
    r = decompose(csr_from(g), "semicore*", block_edges=64, backend="numpy",
                  settings=Settings(backend=backend), device="cpu")
    assert r.backend == "numpy"


def test_host_engine_takes_the_reference_positions():
    """``HostEngine(graph, block_edges, pool_blocks, retry, settings)`` by
    position, as the reference's: the pool, the retry policy and the
    Settings all land, and the run equals the reference's."""
    from repro.faults import RetryPolicy as JRetry
    from repro.runtime import Settings as JSettings
    from repro_torch.faults import RetryPolicy
    from repro_torch.runtime import Settings

    g = chung_lu(400, 1600, seed=4)
    retry = RetryPolicy(2, base_delay=0.0)
    eng = HostEngine(csr_from(g), 64, 4, retry,
                     Settings(backend="torch", resident_chunk=2))
    ref = JHostEngine(g, 64, 4, JRetry(2, base_delay=0.0),
                      JSettings(backend="xla", resident_chunk=2))
    assert eng.reader.pool_blocks == 4 and eng.reader.retry is retry
    got = eng.semicore_star("batch", device="cpu")
    assert got.backend == "torch"
    assert_same(got, ref.semicore_star("batch"), "positional")


@pytest.mark.parametrize("schedule", ["seq", "batch"])
def test_numpy_backend_matches_jax(schedule):
    g = chung_lu(400, 1600, seed=3)
    for algorithm in ALGORITHMS:
        want = jdecompose(g, algorithm, schedule, block_edges=64,
                          backend="numpy")
        got = decompose(csr_from(g), algorithm, schedule, block_edges=64,
                        backend="numpy")
        assert_same(got, want, f"{schedule}/{algorithm}")


def test_paper_traces_through_the_cuda_backend():
    """Figs. 2/4/5 of the paper on the batch schedule."""
    pinned = {"semicore": (36, 4, 4, 4), "semicore+": (26, 4, 4, 4),
              "semicore*": (11, 3, 3, 3)}
    g = csr_from(paper_example_graph())
    for algo, (comps, iters, ebr, ntr) in pinned.items():
        r = decompose(g, algo, "batch", block_edges=64, device="cpu")
        np.testing.assert_array_equal(r.core, [3, 3, 3, 3, 2, 2, 2, 2, 1])
        assert (r.node_computations, r.iterations, r.edge_block_reads,
                r.node_table_reads) == (comps, iters, ebr, ntr), algo


def test_structure_cache_follows_graph_version():
    g = csr_from(chung_lu(200, 800, seed=1))
    bg = BufferedGraph(g)
    eng = HostEngine(bg, block_edges=64)
    be = CudaBackend(device="cpu")
    be.retain_structure = True
    r1 = run_batch(eng, "semicore*", be)
    r2 = run_batch(eng, "semicore+", be)
    assert be.structure_builds == 1
    np.testing.assert_array_equal(r1.core, r2.core)
    u, v = map(int, g.edge_list()[0])
    assert bg.delete_edge(u, v)
    r3 = run_batch(eng, "semicore*", be)
    assert be.structure_builds == 2
    np.testing.assert_array_equal(r3.core, imcore_bz(bg.materialize()))
    one_shot = CudaBackend(device="cpu")
    run_batch(HostEngine(g, block_edges=64), "semicore*", one_shot)
    assert one_shot._resident is None
