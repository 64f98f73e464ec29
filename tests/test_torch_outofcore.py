"""The port's storage layer and out-of-core build against the JAX package.

``repro_torch.graph.build_csr`` and ``repro.graph.build_csr`` build the same
seeded edge streams (iterators of ragged chunks, ``.npy`` shards, text edge
lists; self loops, duplicates, empty and isolated graphs, explicit and
inferred ``n``, ``relabel="degree"``): every output file must be byte for
byte the reference's and every ``BuildStats`` field equal.  Then the rest of
the slice on the same inputs: ``CSRGraph`` save/load and its subgraph
methods, ``BlockReader``'s accounting across pool sizes, EMCore field for
field, the web-scale configs, a memmapped graph decomposed on every
substrate (``device="cpu"``) against JAX, and maintenance over a loaded
graph.
"""
import dataclasses
import filecmp
import os
import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.graph as rgraph  # noqa: E402
from repro.configs import semicore_webscale as jwebscale  # noqa: E402
from repro.configs.base import CoreGraphConfig as JCoreGraphConfig  # noqa: E402
from repro.core import CoreMaintainer as JMaintainer  # noqa: E402
from repro.core import UpdateBatch as JBatch  # noqa: E402
from repro.core.emcore import emcore as jemcore  # noqa: E402
from repro.core.semicore import HostEngine as JHostEngine  # noqa: E402
from repro.core.semicore import decompose as jdecompose  # noqa: E402
from repro.runtime import Settings as JSettings  # noqa: E402

import repro_torch.graph as tgraph  # noqa: E402
from repro_torch.configs import CoreGraphConfig, get_config  # noqa: E402
from repro_torch.configs import semicore_webscale as webscale  # noqa: E402
from repro_torch.core import (CoreMaintainer, CudaBackend, HostEngine,  # noqa: E402
                              TorchBackend, UpdateBatch, decompose, emcore,
                              imcore_peel, resolve_backend)
from repro_torch.graph import CSRGraph, build_csr  # noqa: E402
from repro_torch.graph.update_cases import mixed_batch  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402

TABLES = ("indptr.npy", "adj.npy", "meta.json")


def _ragged(e, size=313):
    return [e[i:i + size] for i in range(0, len(e), size)]


def _rand(seed, n, k):
    return np.random.default_rng(seed).integers(0, n, size=(k, 2),
                                                dtype=np.int64)


def _shards(tmp, seed=5, n=300):
    rng = np.random.default_rng(seed)
    paths = []
    for i, k in enumerate((900, 1300, 1)):
        path = str(tmp / f"shard{i}.npy")
        np.save(path, rng.integers(0, n, size=(k, 2), dtype=np.int64))
        paths.append(path)
    return paths, n


def _text(tmp, seed=7, n=120):
    path = str(tmp / "edges.txt")
    with open(path, "w") as f:
        f.write("# SNAP-style header\n% konect header\n\n")
        for u, v in _rand(seed, n, 800):
            f.write(f"{u}\t{v}\n")
    return path, n


def _self_loops():
    """Only self loops and duplicates in both orientations: the loop-only
    chunk is dropped, yet its ids count toward the inferred n."""
    return [np.array([(3, 3), (7, 7)], np.int64),
            np.array([(0, 1), (1, 0), (0, 1), (2, 2)], np.int64),
            np.array([(5, 4), (4, 5)], np.int64)]


#: case -> (edge source builder (tmp_path) -> (source, kwargs)); each source
#: is made twice, once for each builder, so iterators are never shared
BUILDS = {
    "ragged_1024": lambda t: (iter(_ragged(_rand(3, 400, 5000))),
                              dict(n=400, chunk_edges=1024)),
    "ragged_4096": lambda t: (iter(_ragged(_rand(3, 400, 5000))),
                              dict(n=400, chunk_edges=4096)),
    "npy_shards": lambda t: (_shards(t)[0], dict(n=300, chunk_edges=1024)),
    "npy_path": lambda t: (_shards(t)[0][1], dict(n=300, chunk_edges=1024)),
    "text": lambda t: (_text(t)[0], dict(n=120, chunk_edges=1024)),
    "array": lambda t: (_rand(9, 200, 3000), dict(chunk_edges=1024)),
    "inferred_n": lambda t: ([np.array([(0, 9), (3, 4), (9, 3)], np.int64)],
                             {}),
    "self_loops_duplicates": lambda t: (_self_loops(), {}),
    "empty": lambda t: (iter([]), {}),
    "isolated": lambda t: ([np.array([(1, 2)], np.int64)], dict(n=6)),
    "degree_relabel": lambda t: ([_rand(11, 250, 3000)],
                                 dict(n=250, relabel="degree",
                                      chunk_edges=1024)),
    "degree_relabel_ragged": lambda t: (iter(_ragged(_rand(13, 600, 9000),
                                                     500)),
                                        dict(n=700, relabel="degree",
                                             chunk_edges=1024)),
    "many_runs": lambda t: ((e[i:i + 500] for e in [_rand(13, 3000, 60_000)]
                             for i in range(0, len(e), 500)),
                            dict(n=3000, chunk_edges=2048)),
    "rmat_stream": lambda t: (tgraph.rmat_chunks(8, 6, seed=2,
                                                 chunk_edges=500),
                              dict(chunk_edges=1024)),
    "powerlaw_stream": lambda t: (tgraph.powerlaw_chunks(400, 2500, seed=2,
                                                         chunk_edges=700),
                                  dict(chunk_edges=1024)),
    "uniform_stream": lambda t: (tgraph.uniform_chunks(300, 2000, seed=2,
                                                       chunk_edges=611),
                                 dict(chunk_edges=1024)),
}


def _stats_fields(stats) -> tuple:
    d = dataclasses.asdict(stats)
    d.pop("out_dir")
    perm = d.pop("perm")
    return d, perm


def same_tables(a: str, b: str) -> None:
    for f in TABLES:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_build_csr_matches_reference(tmp_path, case):
    src, kw = BUILDS[case](tmp_path)
    got = build_csr(src, str(tmp_path / "port"), **kw)
    src, kw = BUILDS[case](tmp_path)
    want = rgraph.build_csr(src, str(tmp_path / "ref"), **kw)
    same_tables(str(tmp_path / "port"), str(tmp_path / "ref"))
    (gf, gp), (wf, wp) = _stats_fields(got), _stats_fields(want)
    assert gf == wf
    assert (gp is None) == (wp is None)
    if gp is not None:
        np.testing.assert_array_equal(gp, wp)
    assert got.to_json().keys() == want.to_json().keys()
    # and the layout is the port's in-memory from_edges (relabeled by perm)
    g = CSRGraph.load(str(tmp_path / "port"), mmap=True)
    assert isinstance(g.adj, np.memmap) or g.m == 0
    src, kw = BUILDS[case](tmp_path)
    e = np.concatenate([np.asarray(c).reshape(-1, 2)
                        for c in tgraph.build._as_chunks(src, 1024)]
                       or [np.zeros((0, 2), np.int64)])
    mem = CSRGraph.from_edges(got.n, e)
    if got.perm is not None:
        mem = mem.relabel(got.perm)
        assert np.all(np.diff(g.degrees()) <= 0), "degree-descending ids"
    np.testing.assert_array_equal(np.asarray(g.indptr), mem.indptr)
    np.testing.assert_array_equal(np.asarray(g.adj), mem.adj)


@pytest.mark.parametrize("builder", [build_csr, rgraph.build_csr],
                         ids=["port", "reference"])
def test_build_csr_refuses_what_the_reference_refuses(tmp_path, builder):
    e = np.array([(0, 9), (3, 4), (9, 3)], np.int64)
    with pytest.raises(ValueError, match="exceed"):
        builder([e], str(tmp_path / "g"), n=5)
    with pytest.raises(ValueError, match="relabel"):
        builder([e], str(tmp_path / "g"), relabel="random")
    with pytest.raises(ValueError, match="int32"):
        builder([np.array([(0, 1 << 31)], np.int64)], str(tmp_path / "g"))


def test_chunk_sources_match_reference(tmp_path):
    paths, _ = _shards(tmp_path)
    for size in (1, 100, 4096):
        got = list(tgraph.edge_chunks_from_npy(paths, chunk_edges=size))
        want = list(rgraph.edge_chunks_from_npy(paths, chunk_edges=size))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    path, _ = _text(tmp_path)
    for size in (1, 97, 4096):
        got = list(tgraph.edge_chunks_from_text(path, chunk_edges=size))
        want = list(rgraph.edge_chunks_from_text(path, chunk_edges=size))
        assert [len(c) for c in got] == [len(c) for c in want]
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.concatenate(want))
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((4, 3), np.int64))
    with pytest.raises(ValueError, match="expected an"):
        list(tgraph.edge_chunks_from_npy(bad))


@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_chunks_match_reference(seed):
    got = list(tgraph.uniform_chunks(300, 2000, seed=seed, chunk_edges=611))
    want = list(rgraph.uniform_chunks(300, 2000, seed=seed, chunk_edges=611))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_graph_package_exports_the_builder():
    for name in ("build_csr", "BuildStats", "edge_chunks_from_npy",
                 "edge_chunks_from_text", "uniform_chunks"):
        assert name in tgraph.__all__ and hasattr(tgraph, name), name
    assert tgraph.build.DEFAULT_CHUNK_EDGES == rgraph.build.DEFAULT_CHUNK_EDGES
    assert tgraph.build.MERGE_FANOUT == rgraph.build.MERGE_FANOUT


# ----------------------------------------------------------- save / load
GRAPHS = {
    "chung_lu": lambda: rgraph.chung_lu(300, 1200, seed=2),
    "paper": rgraph.paper_example_graph,
    "empty": lambda: rgraph.CSRGraph.from_edges(5, np.zeros((0, 2),
                                                             np.int64)),
}


@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_save_load_round_trip(tmp_path, name, mmap):
    ref = GRAPHS[name]()
    g = csr_from(ref)
    g.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    same_tables(str(tmp_path / "port"), str(tmp_path / "ref"))
    for d in ("port", "ref"):
        back = CSRGraph.load(str(tmp_path / d), mmap=mmap)
        np.testing.assert_array_equal(back.indptr, g.indptr)
        np.testing.assert_array_equal(back.adj, g.adj)
        assert back.indptr.dtype == np.int64 and back.adj.dtype == np.int32
        assert (back.n, back.m) == (g.n, g.m)
        if mmap and g.m:
            # the edge table stays on disk: never copied into memory
            assert isinstance(back.adj, np.memmap)
            assert not back.adj.flags.writeable
        if not mmap:
            assert not isinstance(back.adj, np.memmap)


def test_post_init_keeps_a_memmapped_table(tmp_path):
    csr_from(rgraph.chung_lu(100, 300, seed=1)).save(str(tmp_path / "g"))
    adj = np.load(str(tmp_path / "g" / "adj.npy"), mmap_mode="r")
    g = CSRGraph(indptr=np.load(str(tmp_path / "g" / "indptr.npy")), adj=adj)
    assert g.adj is adj
    # other dtypes are still coerced to the edge table's int32
    assert CSRGraph(indptr=[0, 1, 2], adj=[1, 0]).adj.dtype == np.int32


SUBGRAPHS = {
    "relabel": lambda g, rng: g.relabel(rng.permutation(g.n)),
    "induced_subgraph": lambda g, rng: g.induced_subgraph(
        np.sort(rng.choice(g.n, size=g.n // 3, replace=False))),
    "sample_edges": lambda g, rng: g.sample_edges(0.4, seed=int(rng.integers(9))),
    "sample_nodes": lambda g, rng: g.sample_nodes(0.5, seed=int(rng.integers(9))),
}


@pytest.mark.parametrize("backing", ["inmem", "memmap"])
@pytest.mark.parametrize("method", sorted(SUBGRAPHS))
def test_subgraph_methods_match_reference(tmp_path, method, backing):
    ref = rgraph.chung_lu(250, 1000, seed=4)
    g = csr_from(ref)
    if backing == "memmap":
        g.save(str(tmp_path / "g"))
        g = CSRGraph.load(str(tmp_path / "g"))
    got = SUBGRAPHS[method](g, np.random.default_rng(6))
    want = SUBGRAPHS[method](ref, np.random.default_rng(6))
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.adj, want.adj)


# ----------------------------------------------------------- BlockReader
@pytest.mark.parametrize("pool_blocks", [1, 3, 16, 1000])
def test_block_reader_accounting_matches_reference(tmp_path, pool_blocks):
    ref = rgraph.chung_lu(300, 1500, seed=8)
    g = csr_from(ref)
    g.save(str(tmp_path / "g"))
    port = HostEngine(CSRGraph.load(str(tmp_path / "g")), block_edges=32,
                      pool_blocks=pool_blocks)
    want = JHostEngine(ref, block_edges=32, pool_blocks=pool_blocks)
    port.semicore_star("seq")
    want.semicore_star("seq")
    a, b = port.reader, want.reader
    for f in ("reads", "hits", "node_table_reads", "bytes_read",
              "resident_blocks", "num_blocks"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.resident_blocks) == min(pool_blocks, a.num_blocks)
    assert a.bytes_read == (a.reads + a.node_table_reads) * 32 * 4
    # a batch pass through the pool, then reset_io, as the reference
    blocks = np.arange(0, a.num_blocks, 2)
    a.charge_pass(blocks)
    b.charge_pass(blocks)
    assert (a.reads, a.hits, a.resident_blocks) == \
        (b.reads, b.hits, b.resident_blocks)
    a.reset_io()
    b.reset_io()
    assert (a.reads, a.hits, a.node_table_reads, a.bytes_read,
            a.resident_blocks) == (0, 0, 0, 0, ()) == \
        (b.reads, b.hits, b.node_table_reads, b.bytes_read,
         b.resident_blocks)


# ---------------------------------------------------------------- EMCore
EMCORE_CASES = {
    "chung_lu_default": (lambda: rgraph.chung_lu(400, 2000, seed=3), {}),
    "chung_lu_tight": (lambda: rgraph.chung_lu(400, 2000, seed=3),
                       dict(num_partitions=8, memory_budget_edges=300,
                            block_edges=64)),
    "rmat": (lambda: rgraph.rmat(9, 8, seed=1), dict(num_partitions=5)),
    "erdos_renyi": (lambda: rgraph.erdos_renyi(300, 900, seed=5),
                    dict(num_partitions=32, block_edges=16)),
    "paper": (rgraph.paper_example_graph, dict(num_partitions=3)),
    "empty": (lambda: rgraph.CSRGraph.from_edges(
        4, np.zeros((0, 2), np.int64)), {}),
}


@pytest.mark.parametrize("case", sorted(EMCORE_CASES))
def test_emcore_matches_reference(tmp_path, case):
    make, kw = EMCORE_CASES[case]
    ref = make()
    g = csr_from(ref)
    g.save(str(tmp_path / "g"))
    got = emcore(CSRGraph.load(str(tmp_path / "g")), **kw)
    want = jemcore(ref, **kw)
    np.testing.assert_array_equal(got.core, want.core)
    np.testing.assert_array_equal(got.core, imcore_peel(g))
    for f in ("rounds", "read_blocks", "write_blocks", "peak_memory_edges",
              "over_budget_rounds", "peak_memory_bytes"):
        assert getattr(got, f) == getattr(want, f), f


# --------------------------------------------------------------- configs
#: the reference's backend names -> the port's
BACKEND_NAMES = {"numpy": "numpy", "pallas": "cuda", "xla": "torch",
                 "shard": "shard"}
WEBSCALE = ("CLUEWEB", "UK", "TWITTER", "CLUEWEB_POOLED", "TWITTER_PALLAS",
            "CLUEWEB_SHARD", "CONFIG")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", WEBSCALE)
def test_webscale_configs_match_reference(name, reduced):
    got, want = getattr(webscale, name), getattr(jwebscale, name)
    assert isinstance(got, CoreGraphConfig)
    if reduced:
        got, want = got.reduced(), want.reduced()
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("backend") == BACKEND_NAMES[w.pop("backend")]
    assert g == w


def test_core_graph_config_defaults_match_reference():
    got = dataclasses.asdict(CoreGraphConfig("x", 1, 2, 3))
    want = dataclasses.asdict(JCoreGraphConfig("x", 1, 2, 3))
    assert got == want
    assert [f.name for f in dataclasses.fields(CoreGraphConfig)] == \
        [f.name for f in dataclasses.fields(JCoreGraphConfig)]


def test_registry_loads_the_webscale_cells():
    assert get_config("semicore-webscale") is webscale.CLUEWEB
    # the shard cell reaches the shard backend with its shard count
    shard = webscale.CLUEWEB_SHARD.compute_backend(device="cpu")
    assert shard.name == "shard" and shard.num_shards == 256
    assert shard.devices == [torch.device("cpu")] * 256
    assert resolve_backend(webscale.CLUEWEB_SHARD.backend,
                           device="cpu").name == "shard"
    # every other cell's backend resolves to a port backend by name
    for name in WEBSCALE[:-2]:
        assert resolve_backend(getattr(webscale, name).backend,
                               device="cpu").name in ("numpy", "cuda")


# ------------------------------------------------- the memmapped decompose
#: port backend -> (the reference's counterpart, REPRO_PALLAS_FUSED, maker)
BACKENDS = {
    "numpy": ("numpy", "1", lambda: "numpy"),
    "cuda": ("pallas-interpret", "1", lambda: CudaBackend(device="cpu")),
    "cuda_per_probe": ("pallas-interpret", "0",
                       lambda: CudaBackend(device="cpu", fused=False)),
    "torch": ("xla", "1", lambda: TorchBackend(device="cpu")),
}
FIELDS = ("iterations", "node_computations", "edge_block_reads",
          "node_table_reads", "updates_per_iter", "computations_per_iter",
          "kernel_blocks_active", "kernel_blocks_skipped", "memory_bytes")


def _built(tmp_path, relabel="none"):
    """A powerlaw stream built by both builders; (port graph, reference
    graph, port stats), each memmapped from its own tables."""
    kw = dict(n=220, chunk_edges=1024, relabel=relabel)
    stats = build_csr(tgraph.powerlaw_chunks(220, 900, seed=5,
                                             chunk_edges=300),
                      str(tmp_path / "port"), **kw)
    rgraph.build_csr(rgraph.powerlaw_chunks(220, 900, seed=5,
                                            chunk_edges=300),
                     str(tmp_path / "ref"), **kw)
    return (CSRGraph.load(str(tmp_path / "port")),
            rgraph.CSRGraph.load(str(tmp_path / "ref")), stats)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("algorithm", ["semicore", "semicore+", "semicore*"])
def test_memmapped_decompose_matches_jax(tmp_path, algorithm, backend):
    ref_backend, fused, make = BACKENDS[backend]
    g, ref, _ = _built(tmp_path)
    with mock.patch.dict(os.environ, {"REPRO_PALLAS_FUSED": fused}):
        want = jdecompose(ref, algorithm, "batch", block_edges=64,
                          backend=ref_backend)
    with warnings.catch_warnings():
        # a read-only memmap must never reach torch.from_numpy
        warnings.simplefilter("error")
        got = decompose(g, algorithm, "batch", block_edges=64,
                        backend=make())
    np.testing.assert_array_equal(got.core, want.core)
    assert (got.cnt is None) == (want.cnt is None)
    if got.cnt is not None:
        np.testing.assert_array_equal(got.cnt, want.cnt)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    inmem = decompose(csr_from(g), algorithm, "batch", block_edges=64,
                      backend=make())
    for f in ("core", "cnt") + FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(inmem, f))


@pytest.mark.parametrize("backend", ["numpy", "cuda", "torch"])
def test_relabeled_decompose_equals_through_perm(tmp_path, backend):
    """``relabel="degree"`` moves ids, not the Jacobi schedule: cores and
    cnt agree through perm, passes and updates per pass are equal, and the
    block and node-table reads (what the relabel is for) may differ."""
    g, _, _ = _built(tmp_path / "a")
    g2, _, stats = _built(tmp_path / "b", relabel="degree")
    make = BACKENDS[backend][2]
    r = decompose(g, "semicore*", block_edges=64, backend=make())
    r2 = decompose(g2, "semicore*", block_edges=64, backend=make())
    np.testing.assert_array_equal(r2.core[stats.perm], r.core)
    np.testing.assert_array_equal(r2.cnt[stats.perm], r.cnt)
    assert r2.iterations == r.iterations
    assert r2.updates_per_iter == r.updates_per_iter
    assert r2.computations_per_iter == r.computations_per_iter


# ---------------------------------------------- maintenance over the disk
@pytest.mark.parametrize("substrate", ["numpy", "cuda", "torch"])
def test_maintainer_over_a_loaded_graph(tmp_path, substrate):
    """CoreMaintainer over a memmapped graph lands where it lands over the
    in-memory graph and where the reference's serial oracle lands: the
    buffer's flush rebuilds an in-memory CSR from the disk tables."""
    ref = rgraph.chung_lu(300, 1400, seed=12)
    g = csr_from(ref)
    g.save(str(tmp_path / "g"))
    loaded = CSRGraph.load(str(tmp_path / "g"))
    r = decompose(g, "semicore*", backend="numpy")
    kw = dict(state=(r.core, r.cnt), block_edges=64, backend=substrate,
              device=None if substrate == "numpy" else "cpu")
    disk = CoreMaintainer(loaded, **kw)
    mem = CoreMaintainer(csr_from(ref), **kw)
    oracle = JMaintainer(rgraph.BufferedGraph(ref), state=(r.core, r.cnt),
                         block_edges=64,
                         settings=JSettings(parallel_maint=False))
    for seed in (1, 2):
        wire = mixed_batch(g, 40, seed=seed)
        sd = disk.apply(UpdateBatch.from_wire(wire))
        sm = mem.apply(UpdateBatch.from_wire(wire))
        oracle.apply(JBatch.from_wire(wire))
        assert dataclasses.asdict(sd) == dataclasses.asdict(sm)
        for m in (disk, mem):
            np.testing.assert_array_equal(m.core, oracle.core)
            np.testing.assert_array_equal(m.cnt, oracle.cnt)
    # the edge table on disk is untouched: the maintainer's writes stay in
    # its buffer and in-memory flushes
    np.testing.assert_array_equal(np.asarray(loaded.adj), g.adj)
    disk.bg.flush()
    assert disk.bg.flushes == 1 and not isinstance(disk.bg.base.adj,
                                                   np.memmap)


def test_flush_hooks_and_count_match_reference():
    ref = rgraph.BufferedGraph(rgraph.chung_lu(60, 200, seed=3),
                               buffer_capacity=3)
    port = tgraph.BufferedGraph(csr_from(ref.base), buffer_capacity=3)
    seen = {"port": [], "ref": []}
    port.add_flush_hook(lambda bg: seen["port"].append(bg.version))
    ref.add_flush_hook(lambda bg: seen["ref"].append(bg.version))
    rng = np.random.default_rng(4)
    for u, v in rng.integers(0, 60, size=(40, 2)):
        for bg in (port, ref):
            bg.insert_edge(int(u), int(v))
            bg.delete_edge(int(v), int(u + 1) % 60)
    for bg in (port, ref):
        bg.flush()
    assert port.flushes == ref.flushes > 0
    assert seen["port"] == seen["ref"] and len(seen["port"]) == port.flushes
    np.testing.assert_array_equal(port.base.adj, ref.base.adj)
