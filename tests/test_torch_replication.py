"""The port's WAL tailing, read replicas, corruption handling and chaos
soak against the JAX package.

Each scenario runs once on the reference (``repro.stream`` with
``repro.faults``, numpy) and once on the port (``repro_torch.stream`` with
``repro_torch.faults``; numpy, and where noted ``cuda`` with
``device="cpu"``, the kernels' plain versions), from the same seeded
graphs, op streams and fault plans.  What each observes — epochs, typed
errors and their byte offsets, (core, cnt), replies and watermarks, stats,
health and the fault log — must be the same, and the final state must be
the in-memory oracle's (``imcore_bz`` of the final graph).  The subsets
are the bit-flip matrices and the writer / replica corruption cases of
``tests/test_faults.py``, its 8-seed chaos soak, and the replica and
crash-recovery matrix of ``tests/test_replication.py``.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.faults as jfaults  # noqa: E402
import repro.stream as jstream  # noqa: E402
from repro.core import imcore_bz  # noqa: E402
from repro.graph import chung_lu  # noqa: E402

import repro_torch.faults as tfaults  # noqa: E402
import repro_torch.stream as tstream  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402
from repro_torch.obs.metrics import counter as tcounter  # noqa: E402

JAX = SimpleNamespace(name="jax", stream=jstream, faults=jfaults,
                      graph=lambda g: g, place={})
PORT = SimpleNamespace(name="port", stream=tstream, faults=tfaults,
                       graph=csr_from, place={"backend": "numpy"})
PORT_CUDA = SimpleNamespace(name="port_cuda", stream=tstream, faults=tfaults,
                            graph=csr_from,
                            place={"backend": "cuda", "device": "cpu"})


def batches(ops, size):
    return [ops[i:i + size] for i in range(0, len(ops), size)]


def both(tmp_path, scenario, ports=(PORT,), **kw):
    """``scenario(pkg, dir)`` on the reference and on each port package;
    every port's observations must equal the reference's."""
    want = scenario(JAX, tmp_path / "jax", **kw)
    for pkg in ports:
        got = scenario(pkg, tmp_path / pkg.name, **kw)
        assert _plain(got) == _plain(want), pkg.name
    return want


def _plain(x):
    """Observations as plain Python values, arrays as lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def state(svc):
    return (svc.epoch, svc.maintainer.core.copy(), svc.maintainer.cnt.copy())


def exact(svc):
    """(core == the oracle's on the final graph), recorded as a fact."""
    g = svc.bg.materialize()
    return bool(np.array_equal(
        svc.maintainer.core, imcore_bz(jstream_graph(g))))


def jstream_graph(g):
    """The reference's CSRGraph over ``g``'s arrays (``imcore_bz`` takes
    either package's graph by its fields)."""
    from repro.graph import CSRGraph

    return CSRGraph(indptr=np.asarray(g.indptr, dtype=np.int64),
                    adj=np.asarray(g.adj, dtype=np.int32))


def make_writer(pkg, root, *, n=300, m=1200, seed=3, **kw):
    g = pkg.graph(chung_lu(n, m, seed=seed))
    kw.setdefault("block_edges", 128)
    root.mkdir(parents=True, exist_ok=True)
    w = pkg.stream.CoreWriter(g, wal_path=str(root / "wal.log"),
                              snapshot_dir=str(root / "snaps"),
                              **pkg.place, **kw)
    return w, str(root / "wal.log"), str(root / "snaps")


def replica(pkg, wal, snaps, **kw):
    kw.setdefault("block_edges", 128)
    return pkg.stream.CoreReplica(snapshot_dir=snaps, wal_path=wal,
                                  **pkg.place, **kw)


def mixed(w, num, seed):
    return jstream.mixed_stream(jstream_graph(w.bg.materialize()), num,
                                seed=seed)[0]


# ================================================ WAL corruption matrix
N_RECORDS = 5


def framed_wal(pkg, path, n):
    """A WAL of n framed records, epochs 1..n, one insert each."""
    w = pkg.stream.WriteAheadLog(path)
    for e in range(1, n + 1):
        w.append(e, pkg.stream.UpdateBatch.from_pairs([], [(0, e)]))
    w.close()


def flip_record(pkg, path, k):
    """Flip one payload bit inside record k (0-based); its byte offset."""
    off = 0
    with open(path, "rb") as f:
        lines = f.readlines()
    off = sum(len(x) for x in lines[:k])
    pkg.faults.flip_bit(path, off + len(lines[k]) - 3)
    return off


def _caught(fn):
    """fn()'s value, or the typed error it raised with its offset."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return ("raised", type(e).__name__, getattr(e, "offset", None))


@pytest.mark.parametrize("k", range(N_RECORDS))
def test_bitflip_matrix_replay_tip_and_reopen(tmp_path, k):
    def scenario(pkg, root):
        root.mkdir()
        wal = str(root / "wal.log")
        framed_wal(pkg, wal, N_RECORDS)
        off = flip_record(pkg, wal, k)
        W = pkg.stream.WriteAheadLog
        replay = _caught(lambda: [e for e, _ in W.replay(wal)])
        tip = _caught(lambda: W.tip_epoch(wal))
        W(wal).close()  # reopen: a corrupt final record is truncated
        return off, replay, tip, os.path.getsize(wal), \
            open(wal, "rb").read()

    off, replay, tip, _, _ = both(tmp_path, scenario)
    if k == N_RECORDS - 1:
        assert replay == ("ok", list(range(1, N_RECORDS)))
        assert tip == ("ok", N_RECORDS - 1)
    else:
        assert replay == ("raised", "CorruptionError", off)
        assert tip == ("ok", N_RECORDS)


@pytest.mark.parametrize("k", [1, 2, N_RECORDS - 1])
def test_bitflip_matrix_tailer(tmp_path, k):
    def scenario(pkg, root):
        root.mkdir()
        wal = str(root / "wal.log")
        framed_wal(pkg, wal, N_RECORDS)
        off = flip_record(pkg, wal, k)
        t = pkg.stream.WalTailer(wal)
        got = []

        def drain():
            for rec in t.poll():
                got.append(rec[0])

        first = _caught(drain)
        offset1 = t.offset
        again = _caught(lambda: list(t.poll()))  # the cursor did not move
        return off, got, first, offset1, again, t.offset

    off, got, first, offset1, again, offset2 = both(tmp_path, scenario)
    assert got == list(range(1, k + 1))
    assert first[:2] == again[:2] == ("raised", "CorruptionError")
    assert offset1 == offset2 == off


def test_two_corrupt_tail_records_raise_in_tip_epoch(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        wal = str(root / "wal.log")
        framed_wal(pkg, wal, N_RECORDS)
        flip_record(pkg, wal, N_RECORDS - 1)
        flip_record(pkg, wal, N_RECORDS - 2)
        return _caught(lambda: pkg.stream.WriteAheadLog.tip_epoch(wal))

    assert both(tmp_path, scenario)[:2] == ("raised", "CorruptionError")


# ===================================================== writer recovery
@pytest.mark.parametrize("pkg_port", [PORT, PORT_CUDA], ids=["numpy", "cuda"])
def test_writer_recover_truncates_at_interior_corruption(tmp_path, pkg_port):
    def scenario(pkg, root):
        w, wal, snaps = make_writer(pkg, root)
        w.snapshot()
        for b in batches(mixed(w, 60, 4), 10):
            w.ingest(b)
        w.wal.close()
        flip_record(pkg, wal, 3)  # epoch 4 of 6 becomes unreadable
        w2, rs = pkg.stream.CoreService.recover(
            wal_path=wal, snapshot_dir=snaps, block_edges=128, **pkg.place)
        epochs = [e for e, _ in pkg.stream.WriteAheadLog.replay(wal)]
        return state(w2), vars(rs), epochs, exact(w2)

    st, rs, epochs, ok = both(tmp_path, scenario, ports=(pkg_port,))
    assert st[0] == 3 and epochs == [1, 2, 3] and ok


# ==================================================== replica recovery
def test_replica_corruption_bootstraps_then_rotation_unwedges(tmp_path):
    def scenario(pkg, root):
        w, wal, snaps = make_writer(pkg, root)
        bs = batches(mixed(w, 60, 5), 10)
        for b in bs[:3]:
            w.ingest(b)
        w.snapshot()  # snapshot at epoch 3
        for b in bs[3:]:
            w.ingest(b)  # epochs 4..6
        flip_record(pkg, wal, 1)  # epoch 5, interior
        rep = replica(pkg, wal, snaps)
        seen = [rep.epoch]
        rep.sync()  # re-detects the corruption, falls back to a bootstrap
        seen += [rep.sync_failures, rep.bootstraps, rep.epoch]
        w.snapshot()  # rotation repairs the corrupt record
        seen.append(w.wal.repaired)
        rep.sync()
        return seen, state(rep), state(w), rep.health(), exact(w)

    seen, rs, ws, health, ok = both(tmp_path, scenario)
    assert seen[0] == 4 and seen[1] >= 1 and seen[2] >= 2 and seen[3] == 4
    assert seen[4] == 1 and health["status"] == "ok" and ok
    assert _plain(rs) == _plain(ws)


def no_sleep(_seconds):
    return None


def fast_retry(pkg, retries=4, **kw):
    kw.setdefault("base_delay", 0.0)
    return pkg.faults.RetryPolicy(retries, sleep=no_sleep, **kw)


def test_replica_breaker_trips_transient_polls_to_bootstrap(tmp_path):
    def scenario(pkg, root):
        F = pkg.faults
        w, wal, snaps = make_writer(pkg, root)
        for b in batches(mixed(w, 40, 6), 10):
            w.ingest(b)
        w.snapshot()
        rep = replica(pkg, wal, snaps, breaker_trip_after=2)
        for b in batches(mixed(w, 20, 7), 10):
            w.ingest(b)
        seen = []
        with F.inject(F.FaultPlan([F.FaultRule("wal.poll", "io_error",
                                               every=1)])):
            rep.sync()
            seen += [rep.stale_serving, rep.breaker.tripped,
                     rep.health()["status"]]
            rep.sync()
            seen += [rep.breaker.tripped, rep.bootstrap_failures,
                     rep.stale_serving]
        seen.append(rep.sync_failures)
        rep.sync()
        seen += [rep.stale_serving, rep.breaker.consecutive_failures]
        return seen, state(rep), state(w), rep.health()

    seen, rs, ws, health = both(tmp_path, scenario)
    assert seen[:3] == [True, False, "degraded"]
    assert seen[3] is True and seen[4] >= 1 and seen[5] is True
    assert seen[6:] == [2, False, 0]
    assert _plain(rs) == _plain(ws) and health["status"] == "ok"


def test_replica_survives_total_outage_and_stays_stale(tmp_path):
    def scenario(pkg, root):
        F = pkg.faults
        w, wal, snaps = make_writer(pkg, root)
        w.snapshot()
        w.ingest([("+", 0, 1)])
        rep = replica(pkg, wal, snaps, breaker_trip_after=1)
        before = rep.epoch
        plan = F.FaultPlan([F.FaultRule("wal.poll", "io_error", every=1),
                            F.FaultRule("snapshot.load", "io_error",
                                        every=1)])
        with F.inject(plan):
            rep.sync()
            seen = [rep.stale_serving, rep.bootstrap_failures,
                    rep.epoch == before, rep.health()["status"]]
        rep.sync()
        return seen, state(rep), state(w)

    seen, rs, ws = both(tmp_path, scenario)
    assert seen[0] and seen[1] >= 1 and seen[2] and seen[3] == "degraded"
    assert _plain(rs) == _plain(ws)


# ========================================================= chaos soak
CHAOS_SEEDS = (11, 23, 37, 41, 59, 67, 73, 89)

CHAOS_RATES = {
    "wal.append": {"io_error": 0.04, "torn_write": 0.03, "bit_flip": 0.02,
                   "latency": 0.04},
    "wal.fsync": {"lying_fsync": 0.2},
    "wal.poll": {"io_error": 0.08},
    "block.read": {"io_error": 0.01},
    "snapshot.save": {"enospc": 0.15},
    "snapshot.load": {"io_error": 0.1},
}


def _chaos(pkg, root, seed):
    F = pkg.faults
    root.mkdir()
    g = chung_lu(240, 960, seed=seed)
    ops, _ = jstream.mixed_stream(g, 80, seed=seed)
    wal, snaps = str(root / "wal.log"), str(root / "snaps")
    plan = F.FaultPlan.chaos(seed, CHAOS_RATES)
    w = pkg.stream.CoreWriter(pkg.graph(g), block_edges=128, wal_path=wal,
                              wal_fsync=True, snapshot_dir=snaps,
                              snapshot_keep=2,
                              retry=fast_retry(pkg, 6, seed=seed),
                              **pkg.place)

    def try_snapshot():
        for _ in range(20):
            try:
                w.snapshot()
                return
            except OSError:
                continue
        pytest.fail("snapshot never succeeded under injected ENOSPC")

    epochs = []
    with F.inject(plan):
        try_snapshot()
        reps = [replica(pkg, wal, snaps, replica_id=i,
                        retry=fast_retry(pkg, 4, seed=seed + i),
                        breaker_trip_after=2) for i in (1, 2)]
        for i, b in enumerate(batches(ops, 10)):
            for _ in range(50):
                try:
                    w.ingest(b)
                    break
                except OSError:
                    continue
            else:
                pytest.fail("ingest never succeeded under injected faults")
            if (i + 1) % 3 == 0:
                try:
                    w.snapshot()
                except OSError:
                    pass
            for r in reps:
                r.sync()
            epochs.append([w.epoch] + [r.epoch for r in reps])
        try_snapshot()
    for r in reps:
        for _ in range(30):
            if r.epoch == w.epoch:
                break
            r.sync()
    return (epochs, [state(r) for r in reps], state(w), exact(w),
            plan.total_injected, dict(plan.injected))


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_soak_stays_bit_identical_to_oracle(tmp_path, seed):
    """Writer + two replicas under a seeded fault schedule: the port meets
    the same faults at the same operations as the reference, and ends, as
    it does, with every replica equal to the writer and the writer equal
    to the oracle; every injected fault is in the port's metric."""
    fam = tcounter("repro_faults_injected_total")
    before = fam.value
    want = _chaos(JAX, tmp_path / "jax", seed)
    got = _chaos(PORT, tmp_path / "port", seed)
    assert _plain(got) == _plain(want)
    epochs, reps, w, ok, injected, _ = got
    assert ok and injected > 0
    for r in reps:
        assert _plain(r) == _plain(w)
    assert fam.value - before == injected


# ================================================================ replicas
def _seeded(pkg, root, n=800, m=3200, seed=6):
    w, wal, snaps = make_writer(pkg, root, n=n, m=m, seed=seed)
    return w, wal, snaps


@pytest.mark.parametrize("pkg_port", [PORT, PORT_CUDA], ids=["numpy", "cuda"])
def test_replica_bootstrap_and_tail_serve_the_writer_replies(tmp_path,
                                                              pkg_port):
    def scenario(pkg, root):
        w, wal, snaps = _seeded(pkg, root)
        chunks = batches(mixed(w, 300, 3), 50)
        for c in chunks[:3]:
            w.ingest(c)
        w.snapshot()
        for c in chunks[3:]:
            w.ingest(c)
        rep = replica(pkg, wal, snaps, keep_views=3)
        nodes = np.arange(w.bg.n)
        out = [vars(rep.last_bootstrap)]
        for r in (w, rep):
            core = r.coreness(nodes)
            out.append((core.tolist(), core.epoch, r.top_k(50).tolist(),
                        r.kcore_members(2).tolist(), int(r.degeneracy()),
                        r.degeneracy().epoch))
        for c in batches(mixed(w, 120, 9), 40):
            w.ingest(c)
        out += [rep.lag(), rep.sync(), rep.lag(), state(rep), state(w),
                [v.epoch for v in rep.views]]
        st = rep.replica_stats()
        st.pop("backend")
        out.append(st)
        return out

    out = both(tmp_path, scenario, ports=(pkg_port,))
    assert out[0]["warm_restart"] and out[0]["replayed_batches"] == 3
    assert out[1] == out[2]
    assert out[3:6] == [3, 3, 0]
    assert _plain(out[6]) == _plain(out[7])
    assert out[8] == [7, 8, 9]


def test_replica_rebootstraps_across_rotation_gap(tmp_path):
    def scenario(pkg, root):
        w, wal, snaps = _seeded(pkg, root)
        w.snapshot()
        rep = replica(pkg, wal, snaps)
        for seed in (11, 12, 13):  # rotations march past the replica
            w.ingest(mixed(w, 60, seed))
            w.snapshot()
        w.ingest(mixed(w, 60, 14))
        rep.sync()  # WalGap inside -> snapshot catch-up -> tail the rest
        seen = [rep.bootstraps, state(rep), state(w)]
        w.ingest(mixed(w, 40, 15))
        seen += [rep.sync(), state(rep), state(w)]
        return seen

    seen = both(tmp_path, scenario)
    assert seen[0] == 2 and seen[3] == 1
    assert _plain(seen[1]) == _plain(seen[2])
    assert _plain(seen[4]) == _plain(seen[5])


def test_replica_requires_a_snapshot(tmp_path):
    w, wal, snaps = _seeded(PORT, tmp_path)
    with pytest.raises(RuntimeError, match="snapshot"):
        replica(PORT, wal, snaps)
    w.close()


# ============================================== crash-recovery fault matrix
def _torn_append(wal_path, epoch):
    with open(wal_path, "a") as f:
        f.write('{"epoch":%d,"del":[[0,' % epoch)


CELLS = {
    "append-no-apply": lambda pkg, w, wal, snaps: w.wal.append(
        w.epoch + 1, pkg.stream.admit_batch(mixed(w, 30, 22),
                                            n=w.bg.n).batch),
    "snap-tmp": lambda pkg, w, wal, snaps: os.makedirs(
        os.path.join(snaps, ".snap_tmp")),
    "rotate-tmp": lambda pkg, w, wal, snaps: open(
        wal + pkg.stream.WriteAheadLog.ROTATE_TMP_SUFFIX, "w").close(),
    "torn-tail": lambda pkg, w, wal, snaps: _torn_append(wal, w.epoch + 1),
    "append-then-torn": lambda pkg, w, wal, snaps: (
        CELLS["append-no-apply"](pkg, w, wal, snaps),
        _torn_append(wal, w.epoch + 2)),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_matrix_recovery_equals_replica_and_oracle(tmp_path, cell):
    """Each cell seeds a writer, injects its fault and crashes; writer
    recovery and a fresh replica bootstrap land on the same exact state as
    the reference's, and on the oracle's."""
    def scenario(pkg, root):
        w, wal, snaps = _seeded(pkg, root)
        chunks = batches(mixed(w, 240, 21), 40)
        for c in chunks[:2]:
            w.ingest(c)
        w.snapshot()
        for c in chunks[2:]:
            w.ingest(c)
        CELLS[cell](pkg, w, wal, snaps)
        w.close()
        w2, rs = pkg.stream.CoreService.recover(
            wal_path=wal, snapshot_dir=snaps, block_edges=128, **pkg.place)
        rep = replica(pkg, wal, snaps)
        leftovers = sorted(os.listdir(root)) + sorted(os.listdir(snaps))
        return vars(rs), state(w2), state(rep), exact(w2), leftovers

    rs, ws, reps, ok, _ = both(tmp_path, scenario)
    assert ok and _plain(ws) == _plain(reps)
    assert rs["replayed_batches"] == (5 if cell.startswith("append") else 4)
