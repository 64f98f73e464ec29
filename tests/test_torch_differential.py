"""The differential sweep on the port: every algorithm × schedule × storage
backing × compute backend of ``repro_torch`` against the JAX package and
the in-memory BZ oracle (Algorithm 1), on the seeded graph families of
``tests/test_differential.py``.

Backings: ``inmem`` (the generator's CSR), ``memmap`` (the CSR saved to
disk and reopened with ``np.memmap``, each package its own save and load:
the out-of-core edge table) and ``buffered`` (a ``BufferedGraph`` whose
base differs from the target graph and whose update buffer patches it
back).  Backends, on the host (``device="cpu"``):
``numpy``; ``cuda``, the fused superstep kernels' plain versions;
``cuda_per_probe``, the per-probe segment sums' plain versions; ``torch``.
The seq schedule is the paper's reference and runs on numpy only.  Every
``DecompResult`` field equals the reference's on the counterpart backend:
numpy; pallas-interpret for cuda, and with ``REPRO_PALLAS_FUSED=0`` (its
per-probe kernels) for cuda per probe; xla for torch.
"""
import functools
import os
import tempfile
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.semicore import decompose as jdecompose  # noqa: E402

from repro_torch.core import CudaBackend, TorchBackend, decompose  # noqa: E402
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph import CSRGraph  # noqa: E402
from repro_torch.interop import buffered_from, csr_from  # noqa: E402

from test_differential import ALGORITHMS, FAMILIES, _with_backing  # noqa: E402

#: port backend -> (the reference's counterpart, REPRO_PALLAS_FUSED for
#: it, the port's backend)
BACKENDS = {
    "numpy": ("numpy", "1", lambda: "numpy"),
    "cuda": ("pallas-interpret", "1", lambda: CudaBackend(device="cpu")),
    "cuda_per_probe": ("pallas-interpret", "0",
                       lambda: CudaBackend(device="cpu", fused=False)),
    "torch": ("xla", "1", lambda: TorchBackend(device="cpu")),
}
#: the reference's backend name in DecompResult -> the port's
NAMES = {"numpy": "numpy", "pallas": "cuda", "xla": "torch"}
BACKINGS = ("inmem", "memmap", "buffered")
CASES = [(s, b) for s in ("seq", "batch") for b in BACKENDS
         if s == "batch" or b == "numpy"]
FIELDS = ("iterations", "node_computations", "edge_block_reads",
          "node_table_reads", "algorithm", "schedule", "updates_per_iter",
          "computations_per_iter", "kernel_blocks_active",
          "kernel_blocks_skipped")


@functools.lru_cache(maxsize=None)
def reference(family: str, algorithm: str, schedule: str, backing: str,
              backend: str, fused: str):
    """(graph, the reference's target, its result)."""
    g = FAMILIES[family]()
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(os.environ, {"REPRO_PALLAS_FUSED": fused}):
        target = _with_backing(g, backing, tmp)
        return g, target, jdecompose(target, algorithm, schedule,
                                     block_edges=64, backend=backend)


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
    ref_backend, fused, make = BACKENDS[backend]
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
    assert got.backend == NAMES[want.backend], what
