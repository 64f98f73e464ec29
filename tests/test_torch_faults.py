"""The port's fault-injection harness against the JAX package's.

``repro_torch.faults`` is the port's own copy of ``repro.faults``: the
seeded plans, the injection surface (``fs``), the retry policy and the
circuit breaker.  Its schedules, backoff delays and power-loss behaviour
are held to the reference's on the same seeds, and a ``BlockReader`` fill
that faults and is retried keeps the paper's I/O accounting exact, as in
the non-streaming half of ``tests/test_faults.py``.
"""
import errno
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.faults as jfaults  # noqa: E402
from repro.core.semicore import HostEngine as JHostEngine  # noqa: E402
from repro.graph import chung_lu  # noqa: E402

from repro_torch.core import HostEngine  # noqa: E402
from repro_torch.faults import (FAULT_KINDS, CircuitBreaker,  # noqa: E402
                                FaultInjected, FaultPlan, FaultRule,
                                RetryPolicy, active_plan, flip_bit, inject,
                                simulate_power_loss)
from repro_torch.faults import fs  # noqa: E402
from repro_torch.graph import BlockReader, CSRGraph  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.metrics import counter  # noqa: E402


def no_sleep(_seconds):
    return None


def fast_retry(retries=4, **kw):
    kw.setdefault("base_delay", 0.0)
    return RetryPolicy(retries, sleep=no_sleep, **kw)


# ============================================================== FaultPlan
def test_fault_kinds_match_reference():
    assert FAULT_KINDS == jfaults.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultRule("block.read", "meteor")


@pytest.mark.parametrize("seed", [7, 8, 123])
def test_chaos_plan_matches_reference_for_its_seed(seed):
    rates = {"wal.append": {"io_error": 0.5, "latency": 0.3},
             "block.*": {"torn_write": 0.2}}
    ops = ["wal.append"] * 40 + ["wal.fsync"] * 10 + ["block.read"] * 30
    got, want = FaultPlan.chaos(seed, rates), jfaults.FaultPlan.chaos(seed,
                                                                      rates)
    for op in ops:
        assert got.decide(op) == want.decide(op), op
    assert got.log == want.log and got.log  # the schedule fired
    assert got.injected == want.injected
    assert got.op_counts == want.op_counts
    again = FaultPlan.chaos(seed, rates)
    for op in ops:
        again.decide(op)
    assert again.log == got.log


def test_scripted_rule_fires_at_exact_nth_op():
    plan = FaultPlan([FaultRule("wal.append", "io_error", nth=3)])
    fired = [plan.decide("wal.append") for _ in range(5)]
    assert [d is not None for d in fired] == [False, False, True, False, False]
    kind, _arg, count = fired[2]
    assert (kind, count) == ("io_error", 3)
    assert plan.injected[("wal.append", "io_error")] == 1


def test_rule_patterns_fnmatch_and_every():
    plan = FaultPlan([FaultRule("wal.*", "latency", every=2, arg=0.0)])
    hits = [plan.decide("wal.append") is not None for _ in range(4)]
    assert hits == [False, True, False, True]
    assert plan.decide("snapshot.save") is None  # pattern does not match
    assert plan.total_injected == 2


def test_injected_faults_are_visible_in_the_metric(tmp_path):
    fam = counter("repro_faults_injected_total")
    reg = metrics.get_registry()
    before, snap = fam.value, reg.snapshot()
    plan = FaultPlan([FaultRule("log.append", "io_error", nth=1)])
    path = str(tmp_path / "log")
    with open(path, "wb") as f, inject(plan):
        with pytest.raises(FaultInjected) as ei:
            fs.write(f, "log.append", b"record\n", path)
        fs.write(f, "log.append", b"record\n", path)
    assert (ei.value.op, ei.value.kind, ei.value.index) == \
        ("log.append", "io_error", 1)
    assert ei.value.errno == errno.EIO and isinstance(ei.value, IOError)
    assert plan.total_injected == 1
    assert fam.value - before == 1
    assert reg.delta(snap)[
        'repro_faults_injected_total{kind="io_error",op="log.append"}'] == 1
    with open(path, "rb") as f:
        assert f.read() == b"record\n"  # the failed write landed nothing


def test_no_plan_means_no_fault():
    assert active_plan() is None
    assert fs._ACTIVE is None and fs._TRACKER is None
    fs.on_op("block.read")  # nothing installed: a no-op
    plan = FaultPlan([FaultRule("*", "io_error")])
    with inject(plan):
        assert active_plan() is plan
        with pytest.raises(FaultInjected):
            fs.on_op("block.read")
    assert active_plan() is None


@pytest.mark.parametrize("kind,landed,code", [
    ("io_error", b"", errno.EIO), ("torn_write", b"abcd", errno.EIO),
    ("enospc", b"abcd", errno.ENOSPC)])
def test_write_faults_land_what_the_reference_lands(tmp_path, kind, landed,
                                                    code):
    for impl, name in ((fs, "port"), (jfaults.fs, "ref")):
        path = str(tmp_path / name)
        plan_cls = FaultPlan if impl is fs else jfaults.FaultPlan
        rule_cls = FaultRule if impl is fs else jfaults.FaultRule
        plan = plan_cls([rule_cls("w", kind, nth=1)])
        with open(path, "wb") as f, impl.inject(plan):
            with pytest.raises(OSError) as ei:
                impl.write(f, "w", b"abcdefgh", path)
        assert ei.value.errno == code
        with open(path, "rb") as f:
            assert f.read() == landed, name


def test_bit_flip_write_matches_reference(tmp_path):
    data = bytes(range(64)) + b"\n"
    out = {}
    for impl, plan_cls, rule_cls, name in (
            (fs, FaultPlan, FaultRule, "port"),
            (jfaults.fs, jfaults.FaultPlan, jfaults.FaultRule, "ref")):
        path = str(tmp_path / name)
        plan = plan_cls([rule_cls("w", "bit_flip")], seed=3)
        with open(path, "wb") as f, impl.inject(plan):
            impl.write(f, "w", data, path)
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["ref"] != data
    diff = np.frombuffer(out["port"], np.uint8) ^ np.frombuffer(data, np.uint8)
    assert int(np.unpackbits(diff).sum()) == 1 and out["port"][-1:] == b"\n"


# ====================================================== power loss, bits
def _durability_run(impl, plan_cls, rule_cls, root):
    """Write, fsync part, rename without a dir fsync, lie once, cut power;
    returns what survived."""
    os.makedirs(root)
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    tmp, final = os.path.join(root, "snap.tmp"), os.path.join(root, "snap")
    with open(final, "wb") as f:
        f.write(b"old snapshot")
    plan = plan_cls([rule_cls("b.fsync", "lying_fsync")],
                    track_durability=True)
    with impl.inject(plan):
        with open(a, "wb") as f:
            impl.write(f, "a.write", b"durable", a)
            f.flush()
            assert impl.fsync(f, "a.fsync", a) is True
            impl.write(f, "a.write", b" lost tail", a)
            f.flush()
        with open(b, "wb") as f:
            impl.write(f, "b.write", b"never synced", b)
            f.flush()
            assert impl.fsync(f, "b.fsync", b) is False  # the drive lies
        with open(tmp, "wb") as f:
            impl.write(f, "snap.write", b"new snapshot", tmp)
            f.flush()
            impl.fsync(f, "snap.fsync", tmp)
        impl.replace(tmp, final)  # no fsync_dir: the rename is not durable
        impl.simulate_power_loss()
    out = {}
    for p in (a, b, final, tmp):
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[os.path.basename(p)] = f.read()
    return out


def test_power_loss_matches_reference(tmp_path):
    got = _durability_run(fs, FaultPlan, FaultRule, str(tmp_path / "port"))
    want = _durability_run(jfaults.fs, jfaults.FaultPlan, jfaults.FaultRule,
                           str(tmp_path / "ref"))
    assert got == want
    assert got == {"a": b"durable", "b": b"", "snap": b"old snapshot"}


def test_dir_fsync_makes_the_rename_durable(tmp_path):
    root = str(tmp_path)
    tmp, final = os.path.join(root, "snap.tmp"), os.path.join(root, "snap")
    with open(final, "wb") as f:
        f.write(b"old")
    with inject(FaultPlan(track_durability=True)):
        with open(tmp, "wb") as f:
            fs.write(f, "snap.write", b"new", tmp)
            f.flush()
            fs.fsync(f, "snap.fsync", tmp)
        fs.replace(tmp, final)
        assert fs.fsync_dir(root) is True
        simulate_power_loss()
    with open(final, "rb") as f:
        assert f.read() == b"new"
    assert not os.path.exists(final + ".preloss_shadow")


def test_power_loss_needs_a_tracking_plan():
    with pytest.raises(RuntimeError, match="track_durability"):
        simulate_power_loss()
    with inject(FaultPlan()):
        with pytest.raises(RuntimeError, match="track_durability"):
            simulate_power_loss()


@pytest.mark.parametrize("byte_index,bit", [(0, 0), (5, 7), (-1, 3), (-9, 9)])
def test_flip_bit_matches_reference(tmp_path, byte_index, bit):
    data = bytes(range(16))
    for name, flip in (("port", flip_bit), ("ref", jfaults.flip_bit)):
        with open(tmp_path / name, "wb") as f:
            f.write(data)
        flip(str(tmp_path / name), byte_index, bit)
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "ref").read_bytes() != data
    flip_bit(str(tmp_path / "port"), byte_index, bit)  # its own inverse
    assert (tmp_path / "port").read_bytes() == data
    with pytest.raises(ValueError, match="outside file"):
        flip_bit(str(tmp_path / "port"), 16)


# ======================================================= retry / breaker
def test_retry_delays_deterministic_and_equal_to_reference():
    mk = lambda cls: cls(4, base_delay=0.01, max_delay=0.05, jitter=0.5,  # noqa: E731
                         seed=9, sleep=no_sleep)
    a, b = list(mk(RetryPolicy).delays()), list(mk(RetryPolicy).delays())
    assert a == b == list(mk(jfaults.RetryPolicy).delays()) and len(a) == 4
    assert all(0 < d <= 0.05 for d in a)
    nojit = RetryPolicy(3, base_delay=0.01, max_delay=1.0, jitter=0.0,
                        sleep=no_sleep)
    assert list(nojit.delays()) == [0.01, 0.02, 0.04]
    with pytest.raises(ValueError, match="retries"):
        RetryPolicy(-1)


def test_retry_deadline_stops_early():
    p = RetryPolicy(10, base_delay=0.5, jitter=0.0, deadline=1.0,
                    sleep=no_sleep)
    q = jfaults.RetryPolicy(10, base_delay=0.5, jitter=0.0, deadline=1.0,
                            sleep=no_sleep)
    assert list(p.delays()) == list(q.delays())
    assert len(list(p.delays())) < 10


def test_retry_call_recovers_then_exhausts():
    retried = counter("repro_retries_total")
    exhausted = counter("repro_retries_exhausted_total")
    r0, e0 = retried.value, exhausted.value
    calls = {"n": 0}
    slept = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    p = RetryPolicy(4, base_delay=0.01, jitter=0.0, sleep=slept.append)
    assert p.call(flaky, op="unit") == "ok"
    assert calls["n"] == 3 and slept == [0.01, 0.02]
    assert retried.value - r0 == 2

    def always():
        raise OSError("permanent")

    with pytest.raises(OSError):
        fast_retry(2).call(always, op="unit")
    assert exhausted.value - e0 == 1


def test_retry_only_catches_listed_exceptions():
    def bad():
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        fast_retry(3).call(bad, op="unit", retry_on=(OSError,))


def test_circuit_breaker_trips_once_then_resets():
    b, j = CircuitBreaker(trip_after=3), jfaults.CircuitBreaker(trip_after=3)
    assert [b.record_failure() for _ in range(4)] == \
        [j.record_failure() for _ in range(4)] == [False, False, True, False]
    assert b.tripped and b.trips == 1
    b.record_success()
    assert not b.tripped and b.consecutive_failures == 0
    b.record_failure()
    b.reset()
    assert b.consecutive_failures == 0 and b.trips == 1
    with pytest.raises(ValueError):
        CircuitBreaker(trip_after=0)


# =========================================================== BlockReader
@pytest.mark.parametrize("pool_blocks", [1, 8])
def test_block_read_fault_then_retry_keeps_accounting_exact(pool_blocks):
    ref = chung_lu(400, 1600, seed=2)
    g = csr_from(ref)
    clean = HostEngine(g, block_edges=32, pool_blocks=pool_blocks)
    res_clean = clean.semicore_star("seq")

    plan = FaultPlan([FaultRule("block.read", "io_error", every=13)])
    eng = HostEngine(g, block_edges=32, pool_blocks=pool_blocks,
                     retry=fast_retry(6))
    with inject(plan):
        res = eng.semicore_star("seq")
    assert plan.total_injected > 0
    np.testing.assert_array_equal(res.core, res_clean.core)
    np.testing.assert_array_equal(res.cnt, res_clean.cnt)
    a, b = clean.reader, eng.reader
    assert res.edge_block_reads == b.reads
    if pool_blocks > 1:
        # a failed fill is never charged: with a pool that holds the span,
        # the retried run's misses equal the clean run's exactly, and
        # re-touching the span's filled prefix books as pool hits
        assert b.reads == a.reads
        assert b.hits >= a.hits
        assert b.resident_blocks == a.resident_blocks
    else:
        # one buffer: a fault mid-span has evicted the span's prefix, so
        # the retry reads it again
        assert b.reads > a.reads

    # the reference under the same schedule counts the same
    jplan = jfaults.FaultPlan([jfaults.FaultRule("block.read", "io_error",
                                                 every=13)])
    jeng = JHostEngine(ref, block_edges=32, pool_blocks=pool_blocks,
                       retry=jfaults.RetryPolicy(6, base_delay=0.0,
                                                 sleep=no_sleep))
    with jfaults.inject(jplan):
        jeng.semicore_star("seq")
    assert (b.reads, b.hits, b.node_table_reads) == \
        (jeng.reader.reads, jeng.reader.hits, jeng.reader.node_table_reads)
    assert plan.log == jplan.log


def test_block_read_without_retry_propagates():
    g = csr_from(chung_lu(100, 400, seed=2))
    eng = HostEngine(g, block_edges=32, pool_blocks=4)
    with inject(FaultPlan([FaultRule("block.read", "io_error", nth=1)])):
        with pytest.raises(FaultInjected):
            eng.semicore_star("seq")
    assert eng.reader.reads == 0 and eng.reader.resident_blocks == ()


def test_block_read_retry_reaches_the_maintainer():
    from repro_torch.core import CoreMaintainer, UpdateBatch
    from repro_torch.graph.update_cases import mixed_batch
    from repro_torch.runtime import Settings

    g = csr_from(chung_lu(200, 800, seed=4))
    batch = UpdateBatch.from_wire(mixed_batch(g, 20, seed=1))
    serial = Settings(backend="numpy", parallel_maint=False)
    m = CoreMaintainer(g, block_edges=32, settings=serial,
                       retry=fast_retry(6))
    assert m.engine.reader.retry is not None
    plan = FaultPlan([FaultRule("block.read", "io_error", every=5)])
    with inject(plan):
        m.apply(batch)
    assert plan.total_injected > 0
    clean = CoreMaintainer(g, block_edges=32, settings=serial)
    clean.apply(batch)
    np.testing.assert_array_equal(m.core, clean.core)
    np.testing.assert_array_equal(m.cnt, clean.cnt)


class _FailingTable:
    """An edge table whose page-in fails: slicing raises OSError."""

    def __init__(self, adj):
        self._adj = adj

    def __len__(self):
        return len(self._adj)

    def __getitem__(self, key):
        raise OSError(errno.EIO, "page-in failed")


def test_load_neighbors_undoes_its_charges_on_a_failed_page_in():
    g = csr_from(chung_lu(100, 600, seed=3))
    reader = BlockReader(g, block_edges=8, pool_blocks=64)
    reader.load_neighbors(0)
    reads, pool = reader.reads, reader.resident_blocks
    v = int(np.argmax(g.degrees()))  # a list spanning several blocks
    bad = CSRGraph.__new__(CSRGraph)
    bad.indptr, bad.adj = g.indptr, _FailingTable(g.adj)
    reader.graph = bad
    with pytest.raises(OSError):
        reader.load_neighbors(v)
    # the fills of the failed call are gone and not charged; blocks that
    # were resident before it stay
    assert reader.reads == reads
    assert set(reader.resident_blocks) <= set(pool)
