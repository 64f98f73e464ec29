"""The port's streaming core service against the JAX package, bit for bit.

``repro_torch.stream`` and ``repro.stream`` run the same seeded graphs and
op streams.  The reference writer runs on numpy (its default); the port's
writer on ``numpy``, on ``cuda`` (the kernels' plain versions,
``device="cpu"``), on ``cuda`` per probe and on ``torch``.  Every epoch's
(core, cnt), every query reply and its watermark, the WAL's bytes and every
snapshot file (``manifest.json`` included) must be the reference's; the
numeric ``BatchStats`` / ``RecoveryStats`` / ``BootstrapStats`` fields
must equal the reference's run on the counterpart substrate (numpy with
numpy, the device substrates with xla, whose accounting the port's device
paths share).  Also here: the lane-parallel CRC32C against the
reference's byte loop, the port's gauges, quantiles and Prometheus text,
``WatermarkedArray``'s epochs, the serving registry, the default device,
backpressure, and the stream example on the CPU.
"""
import filecmp
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.stream as jstream  # noqa: E402
from repro.core import imcore_bz as jimcore_bz  # noqa: E402
from repro.graph import chung_lu, paper_example_graph  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.stream import integrity as jintegrity  # noqa: E402

import repro_torch.stream as tstream  # noqa: E402
from repro_torch.core import CudaBackend  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.stream import integrity as tintegrity  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: port substrate -> the service's placement arguments
SUBSTRATES = {
    "numpy": lambda: {"backend": "numpy"},
    "cuda": lambda: {"backend": "cuda", "device": "cpu"},
    "cuda_per_probe": lambda: {"backend": CudaBackend(device="cpu",
                                                      fused=False)},
    "torch": lambda: {"backend": "torch", "device": "cpu"},
}
BATCH_FIELDS = ("epoch", "num_requested", "num_dropped", "num_coalesced",
                "num_applied_deletes", "num_applied_inserts", "num_noops",
                "node_computations", "edge_block_reads", "node_table_reads",
                "iterations", "num_changed", "flushes", "deferred",
                "pending_updates")


def counterpart(substrate: str) -> dict:
    return {} if substrate == "numpy" else {"backend": "xla"}


def batches(ops, size):
    return [ops[i:i + size] for i in range(0, len(ops), size)]


def replies(svc, nodes):
    """Every query kind's reply as (value, watermark)."""
    deg = svc.degeneracy()
    out = [svc.coreness(nodes), svc.in_kcore(nodes, 2), svc.top_k(20),
           svc.kcore_members(2), deg, svc.coreness(int(nodes[0])),
           svc.in_kcore(int(nodes[1]), 2)]
    return [(np.asarray(x).tolist(), x.epoch) for x in out]


def same_files(a: Path, b: Path) -> None:
    """Directories ``a`` and ``b`` hold the same files, byte for byte."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for d in cmp.common_dirs:
        same_files(a / d, b / d)


# ----------------------------------------------------------------- the CRC
@settings(max_examples=60, deadline=None)
@given(size=st.one_of(st.integers(0, 64),
                      st.sampled_from([16383, 16384, 16385, 16388, 65536,
                                       65537, 2 ** 17 + 5, 3 * 2 ** 16 - 1]),
                      st.integers(16000, 140000)),
       seed=st.integers(0, 2 ** 31), crc=st.integers(0, 2 ** 32 - 1))
def test_crc32c_equals_the_reference_loop(size, seed, crc):
    data = np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    want = jintegrity.crc32c(data, crc)
    assert tintegrity.crc32c(data, crc) == want
    assert tintegrity.crc32c_plain(data, crc) == want


@pytest.mark.parametrize("size", [2 ** 20 + 3, 3 * 2 ** 21 + 1])
def test_crc32c_lanes_equal_the_plain_loop_across_blocks(size):
    """Past one block of lanes (64 MiB would take the loop too long here:
    the block rule is the same at any size)."""
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    assert tintegrity.crc32c(data) == tintegrity.crc32c_plain(data)
    half = size // 3
    assert tintegrity.crc32c(data[half:], tintegrity.crc32c(data[:half])) \
        == tintegrity.crc32c(data)
    assert tintegrity.crc32c_combine(
        tintegrity.crc32c(data[:half]), tintegrity.crc32c(data[half:]),
        size - half) == tintegrity.crc32c(data)


def test_frames_equal_the_reference():
    for payload in (b"", b"{}", b'{"epoch":1,"ops":[]}', bytes(range(256))):
        assert tintegrity.frame_record(payload) == \
            jintegrity.frame_record(payload)
        assert tintegrity.unframe(jintegrity.frame_record(payload)) == payload


# ------------------------------------------------------------------ metrics
def _observe(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("repro_x_total", "a counter")
    g = reg.gauge("repro_depth", "a gauge")
    h = reg.histogram("repro_lat_seconds", "a histogram")
    hl = reg.histogram("repro_lag_epochs", "lag",
                       buckets=metrics_mod.DEFAULT_COUNT_BUCKETS)
    c.inc()
    c.labels(kind="a").inc(3)
    g.set(5)
    g.inc(2.5)
    g.labels(replica="1").set(-1)
    g.labels(replica="1").dec()
    for v in (0.0, 0.0002, 0.0031, 0.0031, 0.07, 0.4, 3.0, 12.5):
        h.observe(v)
        h.labels(kind="q").observe(v / 3)
    for v in (0, 0, 1, 3, 7, 2000):
        hl.observe(v)
    qs = [(h.quantile(q), hl.quantile(q), h.labels(kind="q").quantile(q))
          for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    return reg, qs, (g.value, h.count, h.sum, c.value)


def test_gauges_quantiles_and_exposition_equal_the_reference():
    treg, tq, tvals = _observe(tmetrics)
    jreg, jq, jvals = _observe(jmetrics)
    assert tq == jq
    assert tvals == jvals
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.to_dict() == jreg.to_dict()
    assert treg.snapshot() == jreg.snapshot()  # gauges left out of both
    assert treg.get("repro_depth").kind == "gauge"
    assert treg.get("missing") is None
    with pytest.raises(TypeError):
        treg.counter("repro_depth")


def test_shared_bench_block_equals_the_reference():
    from repro.obs import shared_result as jshared
    from repro_torch.obs import shared_result as tshared

    d = {"repro_io_bytes_read_total": 4096.0, "repro_engine_passes_total"
         "{algorithm=\"semicore*\"}": 12.0, "other": 1.0,
         "repro_zero_total": 0.0}
    assert tshared("b", 2.0, d, {"x": 1}) == jshared("b", 2.0, d, {"x": 1})
    assert tshared("b", None, d) == jshared("b", None, d)


# --------------------------------------------------------------- watermarks
WATERMARK_CASES = {
    "slice": lambda a, b, bare: a[1:3].epoch,
    "mask": lambda a, b, bare: a[a >= 3].epoch,
    "reshape": lambda a, b, bare: a.reshape(3, 1).epoch,
    "copy": lambda a, b, bare: a.copy().epoch,
    "add_const": lambda a, b, bare: (a + 1).epoch,
    "compare": lambda a, b, bare: (a >= 3).epoch,
    "negate": lambda a, b, bare: (-a).epoch,
    "maximum_plain": lambda a, b, bare: np.maximum(a, 2).epoch,
    "times_plain": lambda a, b, bare: (a * np.array([1, 2, 3])).epoch,
    "reflected": lambda a, b, bare: (2 ** a).epoch,
    "same_epoch": lambda a, b, bare: (a + a).epoch,
    "mixed_epochs": lambda a, b, bare: (a + b).epoch,
    "mixed_equal": lambda a, b, bare: (a == b).epoch,
    "mixed_minimum": lambda a, b, bare: np.minimum(a, b).epoch,
    "unstamped": lambda a, b, bare: (a + bare).epoch,
    "bare_only": lambda a, b, bare: (bare + 1).epoch,
    "sum_is_scalar": lambda a, b, bare: type(np.add.reduce(a)).__name__,
}


def _stamped(cls, values, epoch):
    a = np.asarray(values).view(cls)
    a.epoch = epoch
    return a


@pytest.mark.parametrize("case", sorted(WATERMARK_CASES))
def test_watermarked_array_keeps_epochs_as_the_reference(case):
    got = []
    for mod in (tstream, jstream):
        cls = mod.WatermarkedArray
        a, b = _stamped(cls, [3, 1, 4], 7), _stamped(cls, [4, 5, 6], 8)
        bare = np.array([7, 8, 9]).view(cls)
        got.append(WATERMARK_CASES[case](a, b, bare))
    assert got[0] == got[1]


def test_watermarked_in_place_ops_restamp_as_the_reference():
    out = []
    for mod in (tstream, jstream):
        cls = mod.WatermarkedArray
        a, b = _stamped(cls, [1, 2, 3], 4), _stamped(cls, [4, 5, 6], 5)
        a += 1
        first = a.epoch
        a += b
        out.append((first, a.epoch, np.asarray(a).tolist()))
    assert out[0] == out[1] == (4, None, [6, 8, 10])


# ----------------------------------------------------- writer, bit for bit
def _writer_run(mod, g, root: Path, ops, place=None, **kw):
    """Ingest ``ops`` in batches of 10 with a snapshot every 3 batches (two
    kept); returns each epoch's (core, cnt), replies and stats."""
    w = mod.CoreWriter(g, block_edges=128, wal_path=str(root / "wal.log"),
                       snapshot_dir=str(root / "snaps"), snapshot_every=3,
                       snapshot_keep=2, **(place or {}), **kw)
    nodes = np.arange(0, w.bg.n, 5)
    seen = [(w.maintainer.core.copy(), w.maintainer.cnt.copy(),
             replies(w, nodes), None)]
    for b in batches(ops, 10):
        s = w.ingest(b)
        seen.append((w.maintainer.core.copy(), w.maintainer.cnt.copy(),
                     replies(w, nodes), [getattr(s, f) for f in BATCH_FIELDS]))
    w.close()
    return w, seen


@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_writer_matches_jax_epoch_by_epoch(tmp_path, substrate):
    g = chung_lu(300, 1200, seed=3)
    ops, _ = jstream.mixed_stream(g, 70, seed=4)
    ref, want = _writer_run(jstream, g, tmp_path / "ref", ops)
    peer, stats = _writer_run(jstream, g, tmp_path / "peer", ops,
                              counterpart(substrate))
    port, got = _writer_run(tstream, csr_from(g), tmp_path / "port", ops,
                            SUBSTRATES[substrate]())
    assert len(got) == len(want) == 8
    for e, ((gc, gn, gr, gs), (wc, wn, wr, _), (_, _, _, ws)) in enumerate(
            zip(got, want, stats)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"core, epoch {e}")
        np.testing.assert_array_equal(gn, wn, err_msg=f"cnt, epoch {e}")
        assert gr == wr, f"replies, epoch {e}"
        assert gs == ws, f"BatchStats, epoch {e}"
    np.testing.assert_array_equal(port.maintainer.core,
                                  jimcore_bz(ref.bg.materialize()))
    # the same log and the same snapshots (epochs 3 and 6), byte for byte
    assert (tmp_path / "port" / "wal.log").read_bytes() == \
        (tmp_path / "ref" / "wal.log").read_bytes()
    same_files(tmp_path / "port" / "snaps", tmp_path / "ref" / "snaps")
    assert sorted(os.listdir(tmp_path / "port" / "snaps")) == [
        "snap_000000000003", "snap_000000000006"]


@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_recovery_and_bootstrap_match_jax(tmp_path, substrate):
    """Each package recovers and bootstraps from the other's files, on
    the same numbers: the reference's files read by the port (on each
    substrate) and the port's read by the reference."""
    g = chung_lu(300, 1200, seed=5)
    ops, _ = jstream.mixed_stream(g, 80, seed=6)
    _writer_run(jstream, g, tmp_path / "ref", ops)
    _writer_run(tstream, csr_from(g), tmp_path / "port", ops,
                SUBSTRATES["numpy"]())
    place, peer = SUBSTRATES[substrate](), counterpart(substrate)
    out = {}
    for name, mod, files, kw in (
            ("port_on_ref", tstream, "ref", place),
            ("ref_on_port", jstream, "port", peer),
            ("ref_on_ref", jstream, "ref", peer)):
        paths = dict(wal_path=str(tmp_path / files / "wal.log"),
                     snapshot_dir=str(tmp_path / files / "snaps"))
        w, rs = mod.CoreWriter.recover(block_edges=128, snapshot_keep=2,
                                       **paths, **kw)
        rep = mod.CoreReplica(block_edges=128, **paths, **kw)
        nodes = np.arange(0, w.bg.n, 3)
        out[name] = (w.maintainer.core, w.maintainer.cnt, rep.maintainer.core,
                     rep.maintainer.cnt, replies(w, nodes),
                     replies(rep, nodes), vars(rs), vars(rep.last_bootstrap))
        w.close()
    want = out.pop("ref_on_ref")
    assert want[6]["replayed_batches"] == 2 and want[6]["warm_restart"]
    for name, got in out.items():
        for i in range(4):
            np.testing.assert_array_equal(got[i], want[i], err_msg=name)
        assert got[4:] == want[4:], name


def test_cross_reads_of_logs_and_snapshots(tmp_path):
    """The reference's SnapshotStore and WalTailer read what the port
    wrote, and the port's read the reference's."""
    g = chung_lu(200, 800, seed=8)
    ops, _ = jstream.mixed_stream(g, 50, seed=9)
    _writer_run(tstream, csr_from(g), tmp_path / "port", ops,
                SUBSTRATES["numpy"]())
    _writer_run(jstream, g, tmp_path / "ref", ops)
    for reader, files in ((jstream, "port"), (tstream, "ref")):
        epoch, graph, core, cnt = reader.SnapshotStore(
            str(tmp_path / files / "snaps"), keep=2).latest()
        assert epoch == 3
        other = (tstream if reader is jstream else jstream).SnapshotStore(
            str(tmp_path / files / "snaps"), keep=2).latest()
        np.testing.assert_array_equal(graph.adj, other[1].adj)
        np.testing.assert_array_equal(core, other[2])
        np.testing.assert_array_equal(cnt, other[3])
        tail = [(e, b.to_wire()) for e, b in reader.WalTailer(
            str(tmp_path / files / "wal.log"), after_epoch=3).poll()]
        assert [e for e, _ in tail] == [4, 5]
        assert tail == [(e, b.to_wire()) for e, b in jstream.WalTailer(
            str(tmp_path / files / "wal.log"), after_epoch=3).poll()]


def test_snapshot_gc_keeps_a_recovered_writer_serving(tmp_path):
    """keep=1: a later save removes the directory the recovered writer's
    graph came from; the snapshot is loaded in memory (mmap=False), so the
    writer ingests on and stays exact."""
    g = chung_lu(300, 1200, seed=10)
    ops, _ = jstream.mixed_stream(g, 60, seed=11)
    paths = dict(wal_path=str(tmp_path / "wal.log"),
                 snapshot_dir=str(tmp_path / "snaps"))
    w = tstream.CoreWriter(csr_from(g), block_edges=128, backend="numpy",
                           **paths)
    for b in batches(ops, 10)[:2]:
        w.ingest(b)
    w.snapshot()
    w.close()
    w2, _ = tstream.CoreWriter.recover(block_edges=128, backend="numpy",
                                       **paths)
    first = sorted(os.listdir(tmp_path / "snaps"))
    w2.ingest(batches(ops, 10)[2])
    w2.snapshot()
    assert sorted(os.listdir(tmp_path / "snaps")) == ["snap_000000000003"]
    assert first == ["snap_000000000002"]
    for b in batches(ops, 10)[3:]:
        w2.ingest(b)
    np.testing.assert_array_equal(w2.maintainer.core,
                                  jimcore_bz(w2.bg.materialize()))


def test_metrics_endpoint_serves_both_formats(tmp_path):
    w = tstream.CoreWriter(csr_from(paper_example_graph()), block_edges=16,
                           backend="numpy")
    w.ingest([("+", 0, 5)])
    w.coreness(0)
    m = w.metrics()
    assert m["epoch"] == 1
    assert "# TYPE repro_service_epoch gauge" in m["prometheus"]
    assert m["json"]["repro_service_queries_total"]["type"] == "counter"
    if tmetrics.obs_enabled():
        assert tmetrics.get_registry().get("repro_service_epoch").value == 1


# ---------------------------------------------------- registry, the device
def test_registry_serves_core_stream_and_replica(tmp_path):
    from repro_torch.serve import (ServeEngine, available_services,
                                   create_service, service_factory)

    assert available_services() == ("core-replica", "core-stream", "lm")
    assert service_factory("lm") is ServeEngine
    g = csr_from(chung_lu(200, 800, seed=1))
    paths = dict(wal_path=str(tmp_path / "wal.log"),
                 snapshot_dir=str(tmp_path / "snaps"))
    svc = create_service("core-stream", g, block_edges=64, device="cpu",
                         **paths)
    assert isinstance(svc, tstream.CoreService)
    svc.snapshot()
    svc.ingest([("+", 0, 1), ("-", 0, 1), ("+", 2, 3)])
    rep = create_service("core-replica", block_edges=64, device="cpu",
                         **paths)
    assert isinstance(rep, tstream.CoreReplica) and rep.epoch == svc.epoch
    np.testing.assert_array_equal(rep.maintainer.core, svc.maintainer.core)
    with pytest.raises(KeyError, match="unknown service"):
        create_service("nope")


def test_entry_points_need_a_gpu_without_device(tmp_path, monkeypatch):
    g = csr_from(chung_lu(200, 800, seed=2))
    paths = dict(wal_path=str(tmp_path / "wal.log"),
                 snapshot_dir=str(tmp_path / "snaps"))
    w = tstream.CoreWriter(g, device="cpu", **paths)
    w.snapshot()
    w.ingest([("+", 0, 1), ("+", 4, 9)])
    w.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.CoreWriter(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.CoreWriter.recover(**paths)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.CoreReplica(**paths)
    w2, rs = tstream.CoreWriter.recover(device="cpu", **paths)
    assert rs.warm_restart and w2.maintainer.backend.name == "cuda"


# ------------------------------------------------------------- backpressure
def _bp_run(mod, g, root, ops, **kw):
    w = mod.CoreWriter(g, block_edges=128, wal_path=str(root / "wal.log"),
                       snapshot_dir=str(root / "snaps"), **kw)
    stats = [w.ingest(b) for b in batches(ops, 12)]
    flags = [(s.deferred, s.pending_updates, s.epoch) for s in stats]
    h = w.health()
    w.snapshot()
    return w, flags, h


@pytest.mark.parametrize("substrate", ["numpy", "cuda"])
def test_backpressure_defers_and_drains_as_the_reference(tmp_path, substrate):
    g = chung_lu(300, 1200, seed=3)
    ops, _ = jstream.mixed_stream(g, 96, seed=8)
    bp = dict(admission_budget=64, admission_soft_ratio=0.15,
              admission_max_defer=3)
    ref, want, wh = _bp_run(jstream, g, tmp_path / "ref", ops, **bp)
    port, got, gh = _bp_run(tstream, csr_from(g), tmp_path / "port", ops,
                            **bp, **SUBSTRATES[substrate]())
    assert [int(d) for d, _, _ in got] == [1, 1, 1, 0, 1, 1, 1, 0]
    assert got == want
    gh["admission"].pop("apply_rate_ewma")
    wh["admission"].pop("apply_rate_ewma")
    assert gh == wh
    assert port.epoch == port._wal_tip == ref.epoch
    np.testing.assert_array_equal(port.maintainer.core, ref.maintainer.core)
    np.testing.assert_array_equal(port.maintainer.cnt, ref.maintainer.cnt)
    assert (tmp_path / "port" / "wal.log").read_bytes() == \
        (tmp_path / "ref" / "wal.log").read_bytes()


def test_overload_sheds_with_typed_retry_after(tmp_path):
    g = csr_from(chung_lu(300, 1200, seed=3))
    w = tstream.CoreWriter(g, block_edges=128, backend="numpy",
                           admission_budget=20)
    present = {tuple(e) for e in w.bg.materialize().edge_list().tolist()}
    absent = [(u, v) for u in range(300) for v in range(u + 1, 300)
              if (u, v) not in present][:40]
    with pytest.raises(tstream.Overloaded) as ei:
        w.ingest([("+", u, v) for u, v in absent])
    assert ei.value.requested == 40 and ei.value.budget == 20
    assert ei.value.retry_after_s > 0 and w.epoch == 0
    assert w.admission.rejected_updates == 40
    w.ingest([("+", u, v) for u, v in absent[:2]])
    assert w.epoch == 1


# ------------------------------------------------------------------ example
def test_stream_example_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "torch_stream_service.py", "--device", "cpu", "--n", "2000",
        "--m", "8000", "--updates", "300", "--batch", "50",
        "--workdir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "torch_stream_service.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "recovered" in out and "exact" in out
