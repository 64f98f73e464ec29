"""The port's shard backend against the JAX package, bit for bit: the
warm and masked settles (an edgeless row that drops counts as an update,
as the reference's shard counts it), ``CoreMaintainer.apply`` in
parallel and serially, structure reuse and ``unbind``, ``CoreWriter``
and ``recover`` on ``"shard"``, the registry, ``recover`` resolving its
settle's backend from ``settings``, and the web-scale example.  Shards
run on the CPU (``devices=["cpu"] * S``); see ``test_torch_shard.py``.
"""
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.stream as jstream  # noqa: E402
from repro.core import CoreMaintainer as JMaintainer  # noqa: E402
from repro.core import UpdateBatch as JBatch  # noqa: E402
from repro.core.engine import ShardedBackend as JShardedBackend  # noqa: E402
from repro.core.engine import warm_settle as jwarm_settle  # noqa: E402
from repro.core.resident import run_resident as jrun_resident  # noqa: E402
from repro.core.semicore import HostEngine as JHostEngine  # noqa: E402
from repro.core.semicore import decompose as jdecompose  # noqa: E402
from repro.graph import BufferedGraph as JBuffered  # noqa: E402
from repro.graph import chung_lu  # noqa: E402
from repro.runtime import Settings as JSettings  # noqa: E402

import repro_torch.stream as tstream  # noqa: E402
from repro_torch.core import (CoreMaintainer, HostEngine,  # noqa: E402
                              TorchBackend, UpdateBatch, decompose,
                              run_resident, warm_settle)
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph import BufferedGraph, CSRGraph  # noqa: E402
from repro_torch.interop import csr_from, update_batch_from  # noqa: E402
from repro_torch.runtime import Settings  # noqa: E402

from test_parallel_maint import FAMILIES as UPDATE_FAMILIES, _graph  # noqa: E402
from test_torch_shard import (CPU, ROOT, STAT_FIELDS,  # noqa: E402,F401
                              TRACE_FIELDS, _one_torch_thread, ref_graph,
                              same, sharded)


# ------------------------------------------------------------ warm settles
def _perturbed(mod_buffered, g, e):
    bg = mod_buffered(g)
    for i in range(6):
        assert bg.delete_edge(*map(int, e[i * 11]))
    ins = [(1, 250), (2, 251), (3, 252)]
    return bg, sum(bg.insert_edge(u, v) for u, v in ins)


@pytest.mark.parametrize("S", (1, 3))
def test_warm_settle_equals_the_reference(S):
    jg = chung_lu(300, 1200, seed=5)
    core0 = jdecompose(jg, "semicore*", "batch", backend="numpy").core
    e = jg.edge_list()
    jbg, ni = _perturbed(JBuffered, jg, e)
    want_np = jwarm_settle(JHostEngine(jbg, block_edges=64), core0, ni,
                           "numpy")
    jbg, _ = _perturbed(JBuffered, jg, e)
    want_sh = jwarm_settle(JHostEngine(jbg, block_edges=64), core0, ni,
                           "shard")
    bg, ni2 = _perturbed(BufferedGraph, csr_from(jg), e)
    assert ni2 == ni
    got = warm_settle(HostEngine(bg, block_edges=64), core0, ni, sharded(S))
    same(got, want_np, TRACE_FIELDS, "vs numpy")
    same(got, want_sh, TRACE_FIELDS + ("shard_pad_edges",) * (S == 1),
         "vs shard")
    np.testing.assert_array_equal(got.core, imcore_bz(bg.materialize()))


def _masked_state(g):
    """A masked-settle state with 8 isolated nodes given a core above 0 (as
    the peeled warm states can), cnt exact w.r.t. it, every isolated node
    in the mask."""
    from repro_torch.core.localcore import compute_cnt_batch

    g = CSRGraph.from_edges(g.n + 8, g.edge_list())
    rng = np.random.default_rng(6)
    core0 = decompose(g, "semicore*", backend="numpy").core
    warm = np.minimum(core0 + rng.integers(0, 3, g.n), g.degrees())
    warm[-8:] = rng.integers(1, 4, 8)
    vals, seg_ptr, _ = HostEngine(g).planner.gather(np.arange(g.n), warm)
    cnt = compute_cnt_batch(vals, seg_ptr, warm)
    mask = rng.random(g.n) < 0.5
    mask[-8:] = True
    return g, warm, cnt, mask


@pytest.mark.parametrize("S", (1, 2, 8))
def test_masked_settle_counts_edgeless_drops_as_the_reference(S):
    g, warm, cnt, mask = _masked_state(csr_from(chung_lu(400, 1600, seed=6)))
    got = run_resident(HostEngine(g, block_edges=64), "semicore*",
                       sharded(S), core=warm, cnt=cnt, settle_mask=mask)
    want = jrun_resident(JHostEngine(ref_graph(g), block_edges=64),
                         "semicore*", JShardedBackend(num_shards=1),
                         core=warm, cnt=cnt,
                         settle_mask=mask)
    torch_run = run_resident(HostEngine(g, block_edges=64), "semicore*",
                             TorchBackend(device=CPU), core=warm, cnt=cnt,
                             settle_mask=mask)
    same(got, want, TRACE_FIELDS, "vs the reference's shard")
    assert got.updates_per_iter == torch_run.updates_per_iter
    np.testing.assert_array_equal(got.core[-8:], 0)
    np.testing.assert_array_equal(got.core[~mask], warm[~mask])



# ------------------------------------------------------------- maintenance
@pytest.mark.parametrize("S", (1, 3))
@pytest.mark.parametrize("family", sorted(UPDATE_FAMILIES))
def test_maintainer_on_shard_equals_the_reference(family, S):
    g, n = _graph("shard", seed=11 + len(family))
    batches = UPDATE_FAMILIES[family](g, n, np.random.default_rng(29))
    oracle = JMaintainer(JBuffered(g), settings=JSettings(
        parallel_maint=False))
    ref = JMaintainer(JBuffered(g), settings=JSettings(
        backend="shard", parallel_maint=True))
    port = CoreMaintainer(BufferedGraph(csr_from(g)), backend=sharded(S))
    for i, ops in enumerate(batches):
        batch = JBatch(ops)
        oracle.apply(batch)
        want = ref.apply(batch)
        got = port.apply(update_batch_from(batch))
        what = f"{family}/S={S} batch {i}"
        np.testing.assert_array_equal(port.core, oracle.core, err_msg=what)
        np.testing.assert_array_equal(port.cnt, oracle.cnt, err_msg=what)
        for f in STAT_FIELDS:
            assert getattr(got, f) == getattr(want, f), f"{what}: {f}"
    np.testing.assert_array_equal(port.core, imcore_bz(port.bg.materialize()))


def test_serial_maintainer_on_shard_equals_the_reference():
    g = chung_lu(300, 1200, seed=12)
    e = g.edge_list()
    ops = [("-", *map(int, e[i])) for i in range(0, 60, 6)] + \
        [("+", 0, 299), ("+", 1, 298)]
    ref = JMaintainer(JBuffered(g), settings=JSettings(
        backend="shard", parallel_maint=False))
    port = CoreMaintainer(BufferedGraph(csr_from(g)), backend=sharded(3),
                          settings=Settings(backend="shard",
                                            parallel_maint=False))
    want = ref.apply(JBatch.from_wire(ops))
    got = port.apply(UpdateBatch.from_wire(ops))
    assert got.algorithm == "batch-settle(shard)"
    np.testing.assert_array_equal(port.core, ref.core)
    np.testing.assert_array_equal(port.cnt, ref.cnt)
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_shard_structure_is_reused_and_rebuilt_per_version(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_NUM_SHARDS", "2")
    g = csr_from(chung_lu(200, 800, seed=7))
    m = CoreMaintainer(g, block_edges=64, backend="shard", device="cpu")
    assert m.backend.retain_structure and m.backend.num_shards == 2
    assert m.backend.structure_builds == 1  # the initial decompose
    non_edge = next((u, v) for u in range(3) for v in range(100, 200)
                    if not m.bg.base.has_edge(u, v))
    s = m.apply(UpdateBatch.from_wire([("-", *non_edge)]))
    assert s.num_noops == 1 and s.num_deletes == 0
    assert m.backend.structure_builds == 1
    e = m.bg.base.edge_list()
    s = m.apply(UpdateBatch.from_wire([("-", *map(int, e[3])),
                                       ("+", 0, 150)]))
    assert s.num_deletes == 1
    assert m.backend.structure_builds == 2
    np.testing.assert_array_equal(m.core, imcore_bz(m.bg.materialize()))


def test_one_shot_run_drops_the_structure_on_unbind():
    from repro_torch.core import run_batch

    be = sharded(2)
    run_batch(HostEngine(csr_from(chung_lu(150, 500, seed=2)),
                         block_edges=64), "semicore*", be)
    assert be._resident is None and be.structure_builds == 1


# ------------------------------------------------------------------ stream
def _writer(mod, g, root, ops, **kw):
    w = mod.CoreWriter(g, block_edges=64, wal_path=str(root / "wal.log"),
                       snapshot_dir=str(root / "snaps"), snapshot_every=2,
                       **kw)
    seen = []
    for i in range(0, len(ops), 10):
        s = w.ingest(ops[i:i + 10])
        seen.append((w.maintainer.core.copy(), w.maintainer.cnt.copy(),
                     s.node_computations, s.edge_block_reads, s.iterations,
                     s.num_changed))
    w.close()
    return seen


def test_writer_and_recovery_on_shard_equal_the_reference(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_NUM_SHARDS", "3")
    g = chung_lu(220, 900, seed=9)
    ops, _ = jstream.mixed_stream(g, 50, seed=4)
    want = _writer(jstream, g, tmp_path / "ref", ops, backend="shard")
    got = _writer(tstream, csr_from(g), tmp_path / "port", ops,
                  backend="shard", device="cpu")
    assert len(got) == len(want) == 5
    for e, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"core {e}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"cnt {e}")
        assert a[2:] == b[2:], f"BatchStats {e}"
    out = {}
    for name, mod, kw in (("port", tstream, dict(device="cpu")),
                          ("ref", jstream, {})):
        w, rs = mod.CoreWriter.recover(
            wal_path=str(tmp_path / name / "wal.log"),
            snapshot_dir=str(tmp_path / name / "snaps"), block_edges=64,
            backend="shard", **kw)
        assert w.maintainer.backend.name == "shard"
        out[name] = (w.maintainer.core, w.maintainer.cnt, vars(rs))
        w.close()
    assert out["port"][2] == out["ref"][2] and out["ref"][2]["warm_restart"]
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])


def test_recover_takes_its_backend_from_settings(tmp_path, monkeypatch):
    """The settle of ``recover`` resolves its backend as the writer does
    (arguments, then ``settings``, then the knob): on a host without a GPU
    the old call (no backend, so the default ``"cuda"`` on cuda:0) raises,
    and ``settings=Settings(backend="numpy")`` now settles on numpy and
    equals the reference's recovery of the same files."""
    g = chung_lu(300, 1200, seed=5)
    ops, _ = jstream.mixed_stream(g, 70, seed=6)
    root = tmp_path / "files"
    w = jstream.CoreWriter(g, block_edges=128, wal_path=str(root / "wal"),
                           snapshot_dir=str(root / "snaps"),
                           snapshot_every=2)
    for i in range(0, len(ops), 10):
        w.ingest(ops[i:i + 10])
    w.close()
    paths = dict(wal_path=str(root / "wal"), snapshot_dir=str(root / "snaps"),
                 block_edges=128)
    want, wrs = jstream.CoreWriter.recover(**paths)
    assert wrs.warm_restart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
    # before the fix the settle ran warm_settle(..., backend=None): cuda:0
    bg = BufferedGraph(csr_from(g))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warm_settle(HostEngine(bg, 128), np.zeros(g.n, np.int64), 0, None)
    got, rs = tstream.CoreWriter.recover(
        settings=Settings(backend="numpy"), **paths)
    assert got.maintainer.backend.name == "numpy"
    assert vars(rs) == vars(wrs)
    np.testing.assert_array_equal(got.maintainer.core, want.maintainer.core)
    np.testing.assert_array_equal(got.maintainer.cnt, want.maintainer.cnt)
    # an explicit backend still wins over settings
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.CoreWriter.recover(settings=Settings(backend="numpy"),
                                   backend="cuda", **paths)
    got.close()
    want.close()


def test_registry_serves_core_stream_on_shard(tmp_path, monkeypatch):
    from repro_torch.serve import create_service

    monkeypatch.setenv("REPRO_TORCH_NUM_SHARDS", "2")
    g = chung_lu(220, 900, seed=9)
    svc = create_service("core-stream", csr_from(g), block_edges=64,
                         backend="shard", device="cpu")
    e = g.edge_list()
    svc.ingest([("-", *map(int, e[0])), ("-", *map(int, e[7])),
                ("+", 0, 100)])
    svc.ingest([("+", 2, 150), ("-", *map(int, e[21]))])
    np.testing.assert_array_equal(svc.maintainer.core,
                                  imcore_bz(svc.bg.materialize()))
    stats = svc.service_stats()
    assert stats["backend"] == "shard"
    assert stats["backend_structure_builds"] >= 1


# --------------------------------------------------------------- example
def test_webscale_example_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "torch_webscale_decomposition.py", "--device", "cpu", "--backend",
        "shard", "--num-shards", "3", "--scale", "10"])
    runpy.run_path(str(ROOT / "examples" / "torch_webscale_decomposition.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "3 shard(s)" in out and "warm restart" in out and "exact" in out

