"""The differential sweep on the port: every algorithm × schedule × storage
backing × compute backend of ``repro_torch`` against the JAX package and
the in-memory BZ oracle (Algorithm 1), on the seeded graph families of
``tests/test_differential.py`` (the port's JAX-free copy,
``repro_torch.graph.differential_cases``, held here to the reference's).

Backings: ``inmem`` (the generator's CSR), ``memmap`` (the CSR saved to
disk and reopened with ``np.memmap``, each package its own save and load:
the out-of-core edge table) and ``buffered`` (a ``BufferedGraph`` whose
base differs from the target graph and whose update buffer patches it
back).  Backends, on the host (``device="cpu"``):
``numpy``; ``cuda``, the fused superstep kernels' plain versions;
``cuda_per_probe``, the per-probe segment sums' plain versions; ``torch``;
``shard_1`` and ``shard_3``, the shard backend at one and three shards.
The seq schedule is the paper's reference and runs on numpy only.  Every
``DecompResult`` field equals the reference's on the counterpart backend:
numpy; pallas-interpret for cuda, and with ``REPRO_PALLAS_FUSED=0`` (its
per-probe kernels) for cuda per probe; xla for torch; numpy for the
shards (whose ``num_shards`` and ``shard_pad_edges`` are the reference's
layout's).
"""
import functools
import os
import tempfile
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.distributed import shard_graph as jshard_graph  # noqa: E402
from repro.core.semicore import decompose as jdecompose  # noqa: E402
from repro.graph import CSRGraph as JCSRGraph  # noqa: E402

from repro_torch.core import (CudaBackend, ShardedBackend,  # noqa: E402
                              TorchBackend, decompose)
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph import CSRGraph  # noqa: E402
from repro_torch.graph.differential_cases import (ALGORITHMS,  # noqa: E402
                                                  BACKINGS, FAMILIES,
                                                  with_backing)
from repro_torch.interop import buffered_from, csr_from  # noqa: E402

import test_differential  # noqa: E402
from test_differential import _with_backing  # noqa: E402

#: port backend -> (the reference's counterpart, REPRO_PALLAS_FUSED for
#: it, the port's backend, its name in DecompResult)
BACKENDS = {
    "numpy": ("numpy", "1", lambda: "numpy", "numpy"),
    "cuda": ("pallas-interpret", "1", lambda: CudaBackend(device="cpu"),
             "cuda"),
    "cuda_per_probe": ("pallas-interpret", "0",
                       lambda: CudaBackend(device="cpu", fused=False),
                       "cuda"),
    "torch": ("xla", "1", lambda: TorchBackend(device="cpu"), "torch"),
    "shard_1": ("numpy", "1", lambda: ShardedBackend(devices=["cpu"]),
                "shard"),
    "shard_3": ("numpy", "1", lambda: ShardedBackend(devices=["cpu"] * 3),
                "shard"),
}
CASES = [(s, b) for s in ("seq", "batch") for b in BACKENDS
         if s == "batch" or b == "numpy"]
FIELDS = ("iterations", "node_computations", "edge_block_reads",
          "node_table_reads", "algorithm", "schedule", "updates_per_iter",
          "computations_per_iter", "kernel_blocks_active",
          "kernel_blocks_skipped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def reference(family: str, algorithm: str, schedule: str, backing: str,
              backend: str, fused: str):
    """(graph, the reference's target, its result)."""
    g = ref_graph(FAMILIES[family]())
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(os.environ, {"REPRO_PALLAS_FUSED": fused}):
        target = _with_backing(g, backing, tmp)
        return g, target, jdecompose(target, algorithm, schedule,
                                     block_edges=64, backend=backend)


def ref_graph(g: CSRGraph) -> JCSRGraph:
    return JCSRGraph(np.asarray(g.indptr), np.asarray(g.adj))


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_and_backings_are_the_references(family, backing,
                                                  tmp_path):
    """The port's copy of the sweep's graphs and backings is the
    reference's, edge for edge (merged view and buffered base alike)."""
    assert sorted(FAMILIES) == sorted(test_differential.FAMILIES)
    assert list(ALGORITHMS) == test_differential.ALGORITHMS
    assert list(BACKINGS) == test_differential.BACKINGS
    got = with_backing(FAMILIES[family](), backing, str(tmp_path / "port"))
    want = _with_backing(test_differential.FAMILIES[family](), backing,
                         str(tmp_path / "ref"))
    assert type(got).__name__ == type(want).__name__
    pairs = [(got, want)]
    if backing == "buffered":
        pairs = [(got.materialize(), want.materialize()),
                 (got.base, want.base)]
    for a, b in pairs:
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.adj, b.adj)


def port_target(target, backing: str, tmp_path):
    """The port's copy of the reference's target; ``memmap`` saved by the
    port and reopened memmapped."""
    if backing == "buffered":
        return buffered_from(target)
    g = csr_from(target)
    if backing == "memmap":
        g.save(str(tmp_path / "g"))
        g = CSRGraph.load(str(tmp_path / "g"), mmap=True)
    return g


@pytest.mark.parametrize("schedule,backend", CASES,
                         ids=[f"{s}-{b}" for s, b in CASES])
@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_differential_matches_jax_and_bz(family, algorithm, backing,
                                         schedule, backend, tmp_path):
    ref_backend, fused, make, name = BACKENDS[backend]
    g, target, want = reference(family, algorithm, schedule, backing,
                                ref_backend, fused)
    got = decompose(port_target(target, backing, tmp_path), algorithm,
                    schedule, block_edges=64, backend=make())
    what = f"{family}/{algorithm}/{schedule}/{backing}/{backend}"
    np.testing.assert_array_equal(got.core, imcore_bz(csr_from(g)),
                                  err_msg=what)
    np.testing.assert_array_equal(got.core, want.core, err_msg=what)
    assert (got.cnt is None) == (want.cnt is None), what
    if got.cnt is not None:  # semicore*: exact Eq. 2 at the fixpoint
        np.testing.assert_array_equal(got.cnt, want.cnt, err_msg=what)
        eq2 = [int((got.core[g.neighbors(v)] >= got.core[v]).sum())
               for v in range(g.n)]
        np.testing.assert_array_equal(got.cnt, eq2, err_msg=what)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"
    assert got.backend == name, what
    if name == "shard":
        S = len(make().devices)
        assert got.num_shards == S, what
        assert got.shard_pad_edges == jshard_graph(g, S).pad_edges, what
