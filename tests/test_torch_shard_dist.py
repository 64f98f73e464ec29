"""The port's shard backend against the JAX package: the reference's
shard at 8 forced JAX devices (a subprocess), ``distributed_decompose``
cold, warm and budgeted, ``max_supersteps``, ``REPRO_TORCH_NUM_SHARDS``,
the raise past the device count, the default devices, ``CLUEWEB_SHARD``
and ``settings``.  Shards run on the CPU (``devices=["cpu"] * S``); see
``test_torch_shard.py``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import semicore_webscale as jwebscale  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.graph import chung_lu  # noqa: E402

from repro_torch import runtime  # noqa: E402
from repro_torch.configs import semicore_webscale as webscale  # noqa: E402
from repro_torch.core import (HostEngine, ShardedBackend,  # noqa: E402
                              TorchBackend, decompose, run_resident)
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph.differential_cases import FAMILIES  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402

from test_torch_shard import (CPU, ROOT, TRACE_FIELDS,  # noqa: E402,F401
                              _one_torch_thread, reference, same, sharded)


_FORCED_DEVICES = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
assert len(jax.devices()) == 8
import torch
from repro.core.engine import ShardedBackend as JShardedBackend
from repro.core.semicore import decompose as jdecompose
from repro.graph import chung_lu, CSRGraph as JCSRGraph
from repro_torch.core import ShardedBackend, decompose
from repro_torch.graph.differential_cases import FAMILIES

FIELDS = ("core", "cnt", "iterations", "node_computations",
          "edge_block_reads", "node_table_reads", "updates_per_iter",
          "computations_per_iter", "kernel_blocks_active",
          "kernel_blocks_skipped", "num_shards", "shard_pad_edges", "backend")
for family in ("powerlaw", "isolated"):
    g = FAMILIES[family]()
    jg = JCSRGraph(np.asarray(g.indptr), np.asarray(g.adj))
    for algo in ("semicore", "semicore+", "semicore*"):
        for S in (2, 8):
            want = jdecompose(jg, algo, "batch", block_edges=64,
                              backend=JShardedBackend(num_shards=S))
            got = decompose(g, algo, "batch", block_edges=64,
                            backend=ShardedBackend(devices=["cpu"] * S))
            for f in FIELDS:
                a, b = getattr(got, f), getattr(want, f)
                ok = (a is None and b is None) if b is None else (
                    np.array_equal(a, b) if isinstance(b, np.ndarray)
                    else a == b)
                assert ok, (family, algo, S, f)
print("SHARD_FORCED_DEVICES_OK")
"""


def test_shard_equals_the_reference_on_8_forced_devices():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _FORCED_DEVICES],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert "SHARD_FORCED_DEVICES_OK" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("name", ["paper", "chung_lu", "rmat"])
def test_distributed_decompose_equals_the_reference(name):
    """``distributed_decompose`` cold and from an upper bound, against the
    reference's on one JAX device and the peeling oracle."""
    from repro.graph import paper_example_graph as jpaper, rmat as jrmat
    from repro_torch.core.imcore import imcore_peel

    jg = {"paper": jpaper, "chung_lu": lambda: chung_lu(2000, 8000, seed=1),
          "rmat": lambda: jrmat(9, 8, seed=2)}[name]()
    g = csr_from(jg)
    expect = imcore_peel(g)
    core, iters = dist.distributed_decompose(g, devices=[CPU] * 2)
    np.testing.assert_array_equal(core, expect)
    assert (core.tolist(), iters) == tuple(
        x.tolist() if isinstance(x, np.ndarray) else x
        for x in jdist.distributed_decompose(jg))
    assert 0 < iters < g.n
    core0 = np.minimum(g.degrees(), expect + 2).astype(np.int32)
    warm, witers = dist.distributed_decompose(g, devices=[CPU] * 2,
                                              core0=core0)
    np.testing.assert_array_equal(warm, expect)
    assert witers == jdist.distributed_decompose(jg, core0=core0)[1]


# ---------------------------------------------------------- budgeted runs
def test_budgeted_prefix_and_warm_restart_equal_the_reference():
    jg = chung_lu(1000, 4000, seed=5)
    g = csr_from(jg)
    expect = imcore_bz(g)
    core, iters = dist.distributed_decompose(g, devices=[CPU] * 3)
    np.testing.assert_array_equal(core, expect)
    assert (core, iters)[1] == jdist.distributed_decompose(jg)[1]
    budget = max(2, iters // 2)
    partial, done = dist.distributed_decompose(g, devices=[CPU] * 3,
                                               max_supersteps=budget)
    jpartial, jdone = jdist.distributed_decompose(jg, max_supersteps=budget)
    assert done == jdone == budget < iters
    np.testing.assert_array_equal(partial, jpartial)
    assert (partial >= expect).all()
    core2, extra = dist.distributed_decompose(g, devices=[CPU] * 3,
                                              core0=partial)
    jcore2, jextra = jdist.distributed_decompose(jg, core0=jpartial)
    np.testing.assert_array_equal(core2, expect)
    np.testing.assert_array_equal(core2, jcore2)
    assert extra == jextra <= iters
    star, _ = dist.distributed_decompose(g, devices=[CPU], star_gating=False)
    np.testing.assert_array_equal(star, expect)


def test_budget_below_the_chunk_is_exact():
    g = csr_from(chung_lu(1000, 4000, seed=5))
    for budget in (1, 3, 9):
        r = run_resident(HostEngine(g), "semicore*", sharded(2),
                         superstep_chunk=4, max_supersteps=budget)
        assert r.iterations == budget


def test_flat_path_refuses_a_budget():
    with pytest.raises(ValueError, match="shard backend"):
        run_resident(HostEngine(csr_from(chung_lu(50, 100, seed=1))),
                     "semicore*", TorchBackend(device=CPU), max_supersteps=2)


# ------------------------------------------------------------ the backend
def test_num_shards_env_and_the_device_count(monkeypatch):
    g = FAMILIES["powerlaw"]()
    with pytest.raises(ValueError, match="device"):
        decompose(g, "semicore*", backend=ShardedBackend(
            num_shards=4096, devices=[CPU]))
    monkeypatch.setenv("REPRO_TORCH_NUM_SHARDS", "3")
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "shard")
    r = decompose(g, "semicore*", "batch", block_edges=64, device="cpu")
    assert r.backend == "shard" and r.num_shards == 3
    same(r, reference("powerlaw", "semicore*", "numpy"), TRACE_FIELDS)
    # fewer shards than listed devices takes the first ones
    be = ShardedBackend(num_shards=2, devices=[CPU] * 5)
    r = decompose(g, "semicore*", "batch", block_edges=64, backend=be)
    assert r.num_shards == 2
    # the per-pass knob does not apply: there is no per-pass loop
    monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
    assert decompose(g, "semicore*", device="cpu").num_shards == 3


def test_default_devices_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.distributed_decompose(FAMILIES["star"]())
    with pytest.raises(ValueError, match="empty"):
        ShardedBackend(devices=[])


def test_clueweb_shard_config_reaches_the_backend():
    got, want = webscale.CLUEWEB_SHARD, jwebscale.CLUEWEB_SHARD
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    be = got.compute_backend(device="cpu")
    assert isinstance(be, ShardedBackend)
    assert be.num_shards == 256 and len(be.devices) == 256
    small = dataclasses.replace(got.reduced(), num_shards=3)
    r = decompose(FAMILIES["powerlaw"](), "semicore*", block_edges=64,
                  backend=small.compute_backend(device="cpu"))
    assert r.num_shards == 3


def test_settings_pick_the_shard_backend(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_NUM_SHARDS", "2")
    r = decompose(FAMILIES["clique"](), "semicore+", block_edges=64,
                  settings=runtime.Settings(backend="shard"), device="cpu")
    assert r.backend == "shard" and r.num_shards == 2


