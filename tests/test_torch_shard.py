"""The port's shard backend against the JAX package, bit for bit: the
layout and the decomposition.

``repro_torch.core.ShardedBackend`` runs one process over a list of torch
devices that may repeat a device, so the CPU runs any shard count
(``devices=["cpu"] * S``), as the reference's tests force 8 host devices.
Held to the reference here: the layout (``balanced_bounds``,
``shard_arrays``, ``shard_graph``, ``sharded_graph_specs``), array for
array; ``decompose`` at S = 1, 2, 3 and 8 over the seven differential
families and three algorithms, every ``DecompResult`` field equal to the
reference's numpy backend (``num_shards``/``shard_pad_edges`` to its
layout) and to its shard backend in process (one JAX device) at S = 1;
the paper example's pinned traces; the plain versions.  The settles,
maintenance and the stream services on the shards are in
``test_torch_shard_settle.py``; budgets, ``distributed_decompose``, the
knobs and 8 forced JAX devices in ``test_torch_shard_dist.py``.
"""
import dataclasses
import functools
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import distributed as jdist  # noqa: E402
from repro.core.semicore import decompose as jdecompose  # noqa: E402
from repro.graph import CSRGraph as JCSRGraph  # noqa: E402
from repro.graph import chung_lu  # noqa: E402

from repro_torch.core import ShardedBackend, decompose  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph import CSRGraph  # noqa: E402
from repro_torch.graph.differential_cases import ALGORITHMS, FAMILIES  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 8)
#: DecompResult fields equal to the reference's numpy run at any S
TRACE_FIELDS = ("iterations", "node_computations", "edge_block_reads",
                "node_table_reads", "algorithm", "schedule",
                "updates_per_iter", "computations_per_iter",
                "kernel_blocks_active", "kernel_blocks_skipped")
ALL_FIELDS = TRACE_FIELDS + ("backend", "num_shards", "shard_pad_edges")
STAT_FIELDS = ("node_computations", "edge_block_reads", "node_table_reads",
               "iterations", "num_changed", "num_deletes", "num_inserts",
               "num_noops", "groups", "largest_group", "fallbacks",
               "settle_passes")


def sharded(S: int, **kw) -> ShardedBackend:
    return ShardedBackend(devices=[CPU] * S, **kw)


def same(got, want, fields, what=""):
    np.testing.assert_array_equal(got.core, want.core, err_msg=what)
    assert (got.cnt is None) == (want.cnt is None), what
    if want.cnt is not None:
        np.testing.assert_array_equal(got.cnt, want.cnt, err_msg=what)
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"


def ref_graph(g: CSRGraph) -> JCSRGraph:
    """The reference's CSRGraph of the port's graph ``g``."""
    return JCSRGraph(np.asarray(g.indptr), np.asarray(g.adj))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shard runs are many small torch ops: one intra-op thread each,
    so that the suite's parallel workers do not oversubscribe the cores
    (restored after the module)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("seed", range(4))
def test_balanced_bounds_is_the_reference_and_minimax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        deg = rng.integers(0, 9, size=rng.integers(3, 12))
        seg_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        n, S = len(deg), int(rng.integers(1, 5))
        bounds = dist.balanced_bounds(seg_ptr, S)
        np.testing.assert_array_equal(
            bounds, jdist.balanced_bounds(seg_ptr, S))
        got = int((seg_ptr[bounds[1:]] - seg_ptr[bounds[:-1]]).max())
        best = min(
            max(seg_ptr[b] - seg_ptr[a]
                for a, b in zip((0,) + cuts, cuts + (n,)))
            for cuts in combinations(range(1, n), min(S - 1, n - 1))
        ) if S > 1 and n > 1 else int(seg_ptr[-1])
        assert got == best


def _same_sharded_graph(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("S", SHARDS)
def test_shard_arrays_and_graph_equal_the_reference(S):
    jg = chung_lu(5000, 40000, seed=3)
    g = csr_from(jg)
    _same_sharded_graph(dist.shard_graph(g, S), jdist.shard_graph(jg, S))
    _same_sharded_graph(
        dist.shard_arrays(np.asarray(g.adj), g.indptr, S, n=g.n),
        jdist.shard_arrays(np.asarray(jg.adj), jg.indptr, S, n=jg.n))
    lay = dist.shard_layout(g.indptr, S, g.n)
    sg = jdist.shard_graph(jg, S)
    assert lay["pad_edges"] == sg.pad_edges
    np.testing.assert_array_equal(lay["bounds"], sg.bounds)


def test_skewed_graph_rebalance_equals_the_reference():
    hub = np.stack([np.zeros(400, np.int64),
                    np.arange(1, 401, dtype=np.int64)], 1)
    path = np.stack([np.arange(401, 800, dtype=np.int64),
                     np.arange(402, 801, dtype=np.int64)], 1)
    g = CSRGraph.from_edges(801, np.concatenate([hub, path]))
    sg = dist.shard_graph(g, 4)
    _same_sharded_graph(sg, jdist.shard_graph(ref_graph(g), 4))
    assert sg.per_shard_edges.max() <= g.degrees().max() + \
        -(-g.num_directed // 4)


def test_shard_int32_validation_raises_loudly():
    with pytest.raises(ValueError, match="int32"):
        dist.shard_arrays(np.zeros(0, np.int32), np.zeros(2, np.int64), 1,
                          n=1 << 31)
    with pytest.raises(ValueError, match="int32"):
        dist.shard_layout(np.array([0, 1 << 31], np.int64), 2, 1)


@pytest.mark.parametrize("n,m,S,dmax", [
    (978_408_098, 85_148_214_938, 256, 75_611_696), (2000, 16_000, 8, 64),
    (7, 0, 1, 0)])
def test_sharded_graph_specs_equal_the_reference(n, m, S, dmax):
    got, probes, V = dist.sharded_graph_specs(n, m, S, dmax)
    want, jprobes, jV = jdist.sharded_graph_specs(n, m, S, dmax)
    assert (probes, V) == (jprobes, jV)
    assert list(got) == list(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape, k
        assert str(dtype).removeprefix("torch.") == str(want[k].dtype), k


# --------------------------------------------------------------- decompose
@functools.lru_cache(maxsize=None)
def reference(family: str, algorithm: str, backend: str):
    return jdecompose(ref_graph(FAMILIES[family]()), algorithm, "batch",
                      block_edges=64, backend=backend)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_decompose_equals_the_reference(family, algorithm, S):
    g = FAMILIES[family]()
    got = decompose(g, algorithm, "batch", block_edges=64,
                    backend=sharded(S))
    what = f"{family}/{algorithm}/S={S}"
    same(got, reference(family, algorithm, "numpy"), TRACE_FIELDS, what)
    np.testing.assert_array_equal(got.core, imcore_bz(g), err_msg=what)
    assert got.backend == "shard" and got.num_shards == S, what
    assert got.shard_pad_edges == dist.shard_graph(g, S).pad_edges, what
    if S == 1:  # the reference's shard backend, on its one CPU device
        same(got, reference(family, algorithm, "shard"), ALL_FIELDS, what)


@pytest.mark.parametrize("S", (1, 2, 3))
def test_shard_pins_the_paper_example_traces(S):
    """The paper's running example walks the numpy backend's pinned batch
    traces (Figs. 2/4/5) at every shard count."""
    from repro_torch.graph import paper_example_graph

    pinned = {"semicore": (36, 4, 4, 4), "semicore+": (26, 4, 4, 4),
              "semicore*": (11, 3, 3, 3)}
    for algo, (comps, iters, ebr, ntr) in pinned.items():
        r = decompose(paper_example_graph(), algo, "batch", block_edges=64,
                      pool_blocks=1, backend=sharded(S))
        np.testing.assert_array_equal(r.core, [3, 3, 3, 3, 2, 2, 2, 2, 1])
        assert (r.node_computations, r.iterations, r.edge_block_reads,
                r.node_table_reads) == (comps, iters, ebr, ntr), algo
        assert r.num_shards == S


def test_plain_shard_equals_the_kernels_route():
    g = FAMILIES["powerlaw"]()
    for algo in ALGORITHMS:
        got = decompose(g, algo, "batch", block_edges=64, backend=sharded(3))
        plain = decompose(g, algo, "batch", block_edges=64,
                          backend=sharded(3, plain=True))
        assert plain.backend == "shard-plain"
        same(got, plain, TRACE_FIELDS + ("num_shards", "shard_pad_edges"),
             algo)


