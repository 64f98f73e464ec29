"""The port's shard backend over a process group, and ``compress_psum``,
against the JAX package.

The port's ranks are gloo processes on the CPU (``repro_torch.launch.ranks``
; their code is ``torch_pg_ranks.py``, which imports no JAX), started
once a shard count for every case.  The reference runs in a subprocess
on forced host devices: its ``ShardedBackend`` on 8, its
``compress_psum`` under ``shard_map`` on 4.  Held here: every listed
``DecompResult`` field of every rank bit for bit the reference's at S = 2
and 4 (three algorithms cold, the warm settle of a graph with buffered
deletes and inserts), every rank equal to every other,
``distributed_decompose`` on the group's mesh, one superstep of the
core-graph cell, and the int8 all-reduce.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import ShardedBackend, decompose, run_resident  # noqa: E402
from repro_torch.core import HostEngine  # noqa: E402
from repro_torch.graph.differential_cases import FAMILIES  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.optim import q8_encode  # noqa: E402

from torch_pg_ranks import (RESULT_FIELDS, SHARD_ALGORITHMS,  # noqa: E402
                            SHARD_FAMILIES)

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
SHARDS = (2, 4)
CASES = [(f, a) for f in SHARD_FAMILIES for a in (*SHARD_ALGORITHMS, "warm")]

_REFERENCE_SHARD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
assert len(jax.devices()) == 8
from repro.core.engine import ShardedBackend, warm_settle
from repro.core.semicore import HostEngine, decompose
from repro.graph import CSRGraph, BufferedGraph
from repro_torch.graph.differential_cases import FAMILIES
sys.path.insert(0, sys.argv[2])
from torch_pg_ranks import (RESULT_FIELDS, SHARD_ALGORITHMS, SHARD_FAMILIES,
                            result_record, warm_updates)

out = sys.argv[1]
for S in (2, 4):
    for family in SHARD_FAMILIES:
        pg = FAMILIES[family]()
        g = CSRGraph(np.asarray(pg.indptr), np.asarray(pg.adj))
        for algo in SHARD_ALGORITHMS:
            r = decompose(g, algo, "batch", block_edges=64,
                          backend=ShardedBackend(num_shards=S))
            np.savez(f"{out}/{family}_{algo}_S{S}.npz", **result_record(r))
            if algo == "semicore*":
                dels, ins = warm_updates(g)
                bg = BufferedGraph(g)
                for u, v in dels:
                    bg.delete_edge(u, v)
                for u, v in ins:
                    bg.insert_edge(u, v)
                w = warm_settle(HostEngine(bg, block_edges=64), r.core,
                                len(ins), ShardedBackend(num_shards=S))
                np.savez(f"{out}/{family}_warm_S{S}.npz", **result_record(w))
print("REFERENCE_SHARD_OK")
"""


def _reference(code: str, out: Path, *args) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code, str(out), *map(str, args)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The reference's runs and each shard count's ranks, once."""
    ref = tmp_path_factory.mktemp("reference")
    _reference(_REFERENCE_SHARD, ref, TESTS)
    runs = {}
    for S in SHARDS:
        out = tmp_path_factory.mktemp(f"ranks{S}")
        run_ranks("torch_pg_ranks:shard_cases", S, backend="gloo", args=[out],
                  paths=[TESTS],
                  timeout=300, env={"OMP_NUM_THREADS": "1"})
        runs[S] = out
    return ref, runs


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _equal(got: dict, want: dict, what: str) -> None:
    for f in ("core", "has_cnt", "cnt") + RESULT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("family,algo", CASES)
def test_every_rank_equals_the_reference(shard_runs, S, family, algo):
    ref, runs = shard_runs
    want = _load(ref / f"{family}_{algo}_S{S}.npz")
    assert int(want["num_shards"]) == S
    for rank in range(S):
        got = _load(runs[S] / f"{family}_{algo}_{rank}.npz")
        _equal(got, want, f"{family} {algo} S={S} rank {rank}")


@pytest.mark.parametrize("S", SHARDS)
def test_ranks_equal_the_one_process_shard_backend(shard_runs, S):
    """The group's result is the device-list backend's at the same S."""
    _, runs = shard_runs
    for family in SHARD_FAMILIES:
        g = FAMILIES[family]()
        for algo in SHARD_ALGORITHMS:
            r = decompose(g, algo, "batch", block_edges=64,
                          backend=ShardedBackend(devices=["cpu"] * S))
            got = _load(runs[S] / f"{family}_{algo}_0.npz")
            np.testing.assert_array_equal(got["core"], r.core)
            assert got["edge_block_reads"] == r.edge_block_reads
            assert list(got["updates_per_iter"]) == r.updates_per_iter


@pytest.mark.parametrize("S", SHARDS)
def test_distributed_decompose_on_the_mesh(shard_runs, S):
    from repro_torch.core.distributed import distributed_decompose
    from repro_torch.core.imcore import imcore_peel

    _, runs = shard_runs
    g = FAMILIES["powerlaw"]()
    core, iters = distributed_decompose(g, devices=["cpu"] * S)
    expect = imcore_peel(g)
    for rank in range(S):
        got = _load(runs[S] / f"dd_{rank}.npz")
        np.testing.assert_array_equal(got["core"], expect)
        np.testing.assert_array_equal(got["wcore"], expect)
        assert int(got["iters"]) == iters
        assert 0 < int(got["witers"]) <= iters


@pytest.mark.parametrize("S", SHARDS)
def test_coregraph_cell_runs_one_superstep(shard_runs, S):
    """The cell's chunk function over the group: one semicore* superstep
    from the degrees, as the one-process backend's budgeted run."""
    _, runs = shard_runs
    g = FAMILIES["powerlaw"]()
    r = run_resident(HostEngine(g), "semicore*",
                     ShardedBackend(devices=["cpu"] * S), max_supersteps=1)
    for rank in range(S):
        got = _load(runs[S] / f"cell_{rank}.npz")
        np.testing.assert_array_equal(got["core"], r.core)
        assert bool(got["ran"]) and int(got["upd"]) == r.updates_per_iter[0]


def test_group_refuses_a_device_list_and_a_wrong_shard_count():
    import torch.distributed as dist

    with pytest.raises(ValueError, match="not both"):
        ShardedBackend(group=object(), devices=["cpu"])
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        be = ShardedBackend(num_shards=2, group=dist.group.WORLD,
                            device="cpu")
        with pytest.raises(ValueError, match="one shard a rank"):
            be.resolve_shards()
        one = decompose(FAMILIES["clique"](), "semicore*", block_edges=64,
                        backend=ShardedBackend(group=dist.group.WORLD,
                                               device="cpu"))
        want = decompose(FAMILIES["clique"](), "semicore*", block_edges=64,
                         backend=ShardedBackend(devices=["cpu"]))
        np.testing.assert_array_equal(one.core, want.core)
        assert one.num_shards == 1 and one.iterations == want.iterations
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- compress_psum
_REFERENCE_COMPRESS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat.jaxshims import shard_map
from repro.optim.optimizer import compress_psum

out = sys.argv[1]
z = np.load(f"{out}/grads.npz")
names = sorted(z.files)
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))

def body(*leaves):
    tree = {k: x[0] for k, x in zip(names, leaves)}
    s = compress_psum(tree, "data")
    return tuple(s[k] for k in names)

fn = shard_map(body, mesh=mesh, in_specs=tuple(P("data") for _ in names),
               out_specs=tuple(P() for _ in names), check_vma=False)
res = jax.jit(fn)(*[jnp.asarray(z[k]) for k in names])
np.savez(f"{out}/sum.npz", **{k: np.asarray(r) for k, r in zip(names, res)})
print("REFERENCE_COMPRESS_OK")
"""


def test_compress_psum_over_four_ranks_equals_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (300,), "c": (2, 129)}
    per_rank = [{k: torch.as_tensor(rng.normal(size=s).astype(np.float32)
                                    * (10.0 ** (r - 2)))
                 for k, s in shapes.items()} for r in range(4)]
    for r, tree in enumerate(per_rank):
        torch.save(tree, tmp_path / f"grads_{r}.pt")
    np.savez(tmp_path / "grads.npz",
             **{k: np.stack([t[k].numpy() for t in per_rank])
                for k in shapes})
    out = tmp_path / "out"
    out.mkdir()
    run_ranks("torch_pg_ranks:compress_cases", 4, backend="gloo",
              args=[tmp_path, out],
              paths=[TESTS], timeout=300, env={"OMP_NUM_THREADS": "1"})
    _reference(_REFERENCE_COMPRESS, tmp_path)
    ref = _load(tmp_path / "sum.npz")
    sums = [torch.load(out / f"sum_{r}.pt") for r in range(4)]
    for k, shape in shapes.items():
        # the int32 sum of the codes, exact: each output element times
        # n^2 over its block's summed scale rounds to it
        codes = [q8_encode(t[k]) for t in per_rank]
        qsum = torch.stack([q.to(torch.int32) for q, _ in codes]).sum(0)
        ssum = torch.stack([s for _, s in codes]).sum(0)
        numel = int(np.prod(shape))
        for r in range(4):
            flat = torch.zeros(qsum.numel())
            flat[:numel] = sums[r][k].reshape(-1)
            got_q = torch.round(flat.reshape(qsum.shape) * 16
                                / ssum[:, None]).to(torch.int32)
            assert torch.equal(got_q.reshape(-1)[:numel],
                               qsum.reshape(-1)[:numel]), (k, r)
            assert torch.equal(sums[r][k], sums[0][k])
        np.testing.assert_allclose(sums[0][k].numpy(), ref[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[k]).max())


def test_compress_psum_needs_an_active_mesh_and_runs_on_one_rank():
    from repro_torch.launch.mesh import Mesh, use_mesh
    from repro_torch.optim import compress_psum, q8_decode

    g = {"w": torch.linspace(-1, 1, 300).reshape(3, 100)}
    with pytest.raises(RuntimeError, match="use_mesh"):
        compress_psum(g, "data")
    with use_mesh(Mesh((1, 1), ("data", "model"), ["cpu"])):
        out = compress_psum(g, "data")
    q, s = q8_encode(g["w"])
    assert torch.equal(out["w"], q8_decode(q, s, (3, 100)))
