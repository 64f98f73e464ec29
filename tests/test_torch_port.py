"""The port as a package: isolation from JAX and from ``repro``, where it
runs, its knobs, and its own copies of the host-side modules.

``repro_torch`` keeps its own copies of the graph, obs, runtime and
host-reference modules; these tests hold each copy to the original on the
same seeded inputs.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as rgraph  # noqa: E402
from repro.core import decompose as jdecompose  # noqa: E402
from repro.core.imcore import imcore_bz as ref_bz, imcore_peel as ref_peel  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core import (CudaBackend, NumpyBackend, decompose,  # noqa: E402
                              resolve_backend, resolve_device)
from repro_torch.core.imcore import imcore_bz, imcore_peel  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import BufferedGraph, CSRGraph  # noqa: E402
from repro_torch.interop import buffered_from, csr_from, warm_state  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402

PKG = Path(repro_torch.__file__).resolve().parent
ROOT = PKG.parents[1]
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
WALKED = ["repro_torch.configs.registry", "repro_torch.configs.shapes",
          "repro_torch.configs.mind", "repro_torch.configs.qwen3_0_6b",
          "repro_torch.data.pipeline", "repro_torch.models.params",
          "repro_torch.models.recsys", "repro_torch.models.transformer",
          "repro_torch.models.layers", "repro_torch.serve.engine",
          "repro_torch.kernels.embedding_bag",
          "repro_torch.kernels.flash_decode", "repro_torch.core.engine",
          "repro_torch.graph.storage", "repro_torch.obs.trace",
          "repro_torch.core.maintenance", "repro_torch.core.parallel_maint",
          "repro_torch.core.update", "repro_torch.graph.update_cases",
          "repro_torch.graph.build", "repro_torch.core.emcore",
          "repro_torch.faults.fs", "repro_torch.faults.plan",
          "repro_torch.faults.retry", "repro_torch.configs.semicore_webscale",
          "repro_torch.obs.bench", "repro_torch.serve.registry",
          "repro_torch.stream.admission", "repro_torch.stream.backpressure",
          "repro_torch.stream.integrity", "repro_torch.stream.replica",
          "repro_torch.stream.service", "repro_torch.stream.wal",
          "repro_torch.stream.workload", "repro_torch.core.distributed",
          "repro_torch.graph.differential_cases",
          "repro_torch.optim.optimizer", "repro_torch.launch.steps",
          "repro_torch.train.checkpoint", "repro_torch.train.trainer"]


def test_ast_walk_covers_every_subpackage():
    """The import check below parses every module of every subpackage."""
    subpackages = {p.parent.name for p in SOURCES if p.name == "__init__.py"}
    assert {"configs", "core", "data", "faults", "graph", "kernels",
            "launch", "models", "obs", "optim", "serve", "stream",
            "train"} <= subpackages


# ------------------------------------------------------------- isolation
def test_package_imports_with_jax_blocked():
    """Every module imports with ``jax`` unimportable, and no module of the
    JAX package gets loaded along the way."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(k for k in sys.modules\n"
        "                      if k.startswith('repro_torch.'))))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked, ok = out.stdout.strip().splitlines()
    assert ok == "ok"
    # the walk reaches every subpackage, the serving ones included
    assert set(WALKED) <= set(walked.split()), set(WALKED) - set(walked.split())


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


# -------------------------------------------------------- where it runs
def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = csr_from(rgraph.paper_example_graph())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decompose(g, "semicore*")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        CudaBackend()
    r = decompose(g, "semicore*", device="cpu")
    np.testing.assert_array_equal(r.core, [3, 3, 3, 3, 2, 2, 2, 2, 1])
    # the host reference needs no device at all
    assert decompose(g, "semicore*", backend="numpy").iterations == 3


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_superstep")
    assert not (tmp_path / "build").exists()


def test_build_caches_by_source_and_flags_and_keeps_the_report(
        monkeypatch, tmp_path):
    """A library is reused only with its ptxas report beside it: one left
    without a report (or built under other flags) is compiled again, so
    ``resource_usage`` always finds the report of the library it reads."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'echo run >> "${0%/*}/calls"\n'
        'while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        ': > "$out"\n'
        "echo \"ptxas info    : Compiling entry function '_Z1av' for "
        "'sm_90a'\"\n"
        'echo "ptxas info    : Used 40 registers, used 1 barriers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def calls():
        return len((tmp_path / "calls").read_text().split())

    lib = _build.build("segsum")
    assert calls() == 1 and _build.build("segsum") == lib and calls() == 1
    assert _build.resource_usage(lib)["_Z1av"]["registers"] == 40
    lib.with_suffix(".log").unlink()  # cached by a build that kept no report
    assert _build.build("segsum") == lib and calls() == 2
    assert _build.resource_usage(lib)["_Z1av"]["registers"] == 40
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    other = _build.build("segsum")
    assert other != lib and calls() == 3 and other.with_suffix(".log").exists()


def test_resource_usage_reads_the_ptxas_report(tmp_path):
    """The build keeps ptxas' report beside each library; registers,
    spills and static shared memory are read back per kernel."""
    lib = tmp_path / "libx-0.so"
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 175 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 1152 bytes smem\n")
    assert _build.resource_usage(lib) == {
        "_Z1av": {"registers": 175, "spill_stores": 8, "spill_loads": 4,
                  "smem": 0},
        "_Z1bv": {"registers": 32, "spill_stores": 0, "spill_loads": 0,
                  "smem": 1152}}


# ------------------------------------------------------------- knobs
def test_backend_knob(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
    assert runtime.setting("backend") == "cuda"
    assert isinstance(resolve_backend(None, "cpu"), CudaBackend)
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "numpy")
    assert isinstance(resolve_backend(None), NumpyBackend)
    # an explicit name wins, as in the reference's resolve_backend
    assert isinstance(resolve_backend("cuda", "cpu"), CudaBackend)
    with pytest.raises(ValueError, match="unknown compute backend"):
        resolve_backend("pallas")


def test_seq_schedule_refuses_a_device_backend(monkeypatch):
    g = csr_from(rgraph.paper_example_graph())
    monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
    assert decompose(g, "semicore*", "seq").node_computations == 11
    with pytest.raises(ValueError, match="seq"):
        decompose(g, "semicore*", "seq", backend="cuda")
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "cuda")
    with pytest.raises(ValueError, match="seq"):
        decompose(g, "semicore*", "seq")


@pytest.mark.parametrize("raw,want", [("4", 4), ("0", 1), ("x", 8)])
def test_chunk_knob_parsing(monkeypatch, raw, want):
    monkeypatch.setenv("REPRO_TORCH_RESIDENT_CHUNK", raw)
    assert runtime.setting("resident_chunk") == want


def test_device_resident_knob(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    assert runtime.setting("device_resident") is False
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "1")
    assert runtime.setting("device_resident") is True


# ------------------------------------------------ copies of host modules
@pytest.mark.parametrize("name,kwargs", [
    ("chung_lu", dict(n=500, m=2000, seed=1)),
    ("erdos_renyi", dict(n=400, m=1500, seed=2)),
    ("rmat", dict(scale=9, edge_factor=6, seed=3)),
    ("ba", dict(n=300, attach=3, seed=4)),
])
def test_generators_match_reference(name, kwargs):
    want = getattr(rgraph, name)(**kwargs)
    got = getattr(tgen, name)(**kwargs)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.adj, want.adj)


def test_powerlaw_chunks_and_from_edges_match_reference():
    kw = dict(n=3000, m=20000, gamma=2.5, seed=0, chunk_edges=7000)
    want = list(rgraph.powerlaw_chunks(**kw))
    got = list(tgen.powerlaw_chunks(**kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    e = np.concatenate(got)
    gw = rgraph.CSRGraph.from_edges(3000, e)
    gg = CSRGraph.from_edges(3000, e)
    np.testing.assert_array_equal(gg.indptr, gw.indptr)
    np.testing.assert_array_equal(gg.adj, gw.adj)
    assert tgen.DATASET_SUITE == rgraph.DATASET_SUITE


def test_imcore_copies_match_reference():
    g = rgraph.chung_lu(600, 3000, seed=7)
    gp = csr_from(g)
    want = ref_bz(g)
    np.testing.assert_array_equal(imcore_bz(gp), want)
    np.testing.assert_array_equal(imcore_peel(gp), ref_peel(g))
    np.testing.assert_array_equal(imcore_peel(gp), want)


@pytest.mark.parametrize("pool", [1, 4])
def test_block_reader_accounting_matches_reference(pool):
    g = rgraph.chung_lu(500, 2500, seed=2)
    for algo in ("semicore", "semicore+", "semicore*"):
        for schedule in ("seq", "batch"):
            want = jdecompose(g, algo, schedule, block_edges=32,
                              pool_blocks=pool, backend="numpy")
            got = decompose(csr_from(g), algo, schedule, block_edges=32,
                            pool_blocks=pool, backend="numpy")
            assert (got.edge_block_reads, got.node_table_reads) == \
                (want.edge_block_reads, want.node_table_reads)
            np.testing.assert_array_equal(got.core, want.core)


def test_buffered_graph_copy_and_interop():
    g = rgraph.chung_lu(300, 1200, seed=5)
    ref = rgraph.BufferedGraph(g, buffer_capacity=64)
    port = BufferedGraph(csr_from(g), buffer_capacity=64)
    e = g.edge_list()
    ops = [("-", *map(int, e[i])) for i in range(0, 40, 3)] + \
        [("+", i, 299 - i) for i in range(20)] + [("-", 1, 298)]
    for op, u, v in ops:
        fn = "delete_edge" if op == "-" else "insert_edge"
        assert getattr(port, fn)(u, v) == getattr(ref, fn)(u, v)
        assert port.version == ref.version
    np.testing.assert_array_equal(port.degrees(), ref.degrees())
    carried = buffered_from(ref)
    assert carried.version == ref.version and carried.m == ref.m
    np.testing.assert_array_equal(carried.degrees(), ref.degrees())
    for v in range(0, 300, 7):
        raw = ref.base.neighbors(v)
        np.testing.assert_array_equal(
            np.sort(carried.merged_neighbors(v, raw)),
            np.sort(ref.merged_neighbors(v, raw)))
    want = ref.materialize()
    for got in (port.materialize(), carried.materialize()):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.adj, want.adj)


def test_warm_state_reads_results_and_pairs():
    g = rgraph.paper_example_graph()
    r = jdecompose(g, "semicore*", "batch", backend="numpy")
    core, cnt = warm_state(r)
    np.testing.assert_array_equal(core, r.core)
    np.testing.assert_array_equal(cnt, r.cnt)
    core[0] = 99  # a copy, not a view
    assert r.core[0] == 3
    assert warm_state([1, 2])[1] is None


# ------------------------------------------------------------------ obs
def test_registry_deltas_reconcile_with_result():
    reg = metrics.get_registry()
    g = csr_from(rgraph.chung_lu(400, 1600, seed=3))
    for algo in ("semicore", "semicore+", "semicore*"):
        snap = reg.snapshot()
        r = decompose(g, algo, "batch", block_edges=64, device="cpu")
        d = reg.delta(snap)
        assert metrics.sum_by_name(d, "repro_engine_passes_total") == \
            r.iterations
        assert metrics.sum_by_name(d, "repro_engine_frontier_nodes_total") \
            == r.node_computations
        assert metrics.sum_by_name(d, "repro_engine_updates_total") == \
            sum(r.updates_per_iter)
        assert metrics.sum_by_name(d, "repro_io_edge_block_reads_total") == \
            r.edge_block_reads
        assert metrics.sum_by_name(d, "repro_io_node_table_reads_total") == \
            r.node_table_reads
        assert metrics.sum_by_name(d, "repro_kernel_blocks_active_total") == \
            r.kernel_blocks_active
        assert metrics.sum_by_name(d, "repro_kernel_blocks_skipped_total") \
            == r.kernel_blocks_skipped


def test_obs_kill_switch_and_trace(monkeypatch):
    reg = metrics.get_registry()
    g = csr_from(rgraph.paper_example_graph())
    monkeypatch.setenv("REPRO_TORCH_OBS", "0")
    snap = reg.snapshot()
    r = decompose(g, "semicore*", device="cpu")
    assert not any(reg.delta(snap).values())
    monkeypatch.delenv("REPRO_TORCH_OBS")
    trace.clear_trace()
    trace.start_trace()
    try:
        r2 = decompose(g, "semicore*", device="cpu")
    finally:
        trace.stop_trace()
    ev = trace.get_collector().to_chrome()["traceEvents"]
    trace.clear_trace()
    np.testing.assert_array_equal(r.core, r2.core)
    assert sum(e["name"] == "resident.chunk" for e in ev) == 1
    assert sum(e["name"] == "superstep.replay" for e in ev) == r2.iterations
