"""The port's edge-update maintenance against the JAX package, bit for bit.

``repro_torch.core.CoreMaintainer`` and ``repro.core.CoreMaintainer`` apply
the same update batches to the same graphs (carried over by
``repro_torch.interop``).  Every substrate of the port — ``numpy``, ``cuda``
(the kernels' plain versions, ``device="cpu"``), ``cuda`` per probe and
``torch`` — must land on the (core, cnt) of the reference's serial oracle
(the paper's per-edge SemiDelete* / SemiInsert* on numpy), and every
numeric ``MaintStats`` field must equal the reference's parallel run on the
counterpart substrate: numpy with numpy, torch with xla, cuda with
pallas-interpret (its per-probe kernels, ``REPRO_PALLAS_FUSED=0``, for
cuda per probe) on two families at the reference's interpret size, and
with xla elsewhere, whose accounting is the same.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import CoreMaintainer as JMaintainer  # noqa: E402
from repro.core import UpdateBatch as JBatch  # noqa: E402
from repro.core import update as jupdate  # noqa: E402
from repro.core.imcore import imcore_bz as jimcore_bz  # noqa: E402
from repro.graph import BufferedGraph as JBuffered  # noqa: E402
from repro.graph import chung_lu, erdos_renyi, paper_example_graph  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.runtime import Settings as JSettings  # noqa: E402
from repro.runtime import _parse_flag as jparse_flag  # noqa: E402

import repro_torch.core.parallel_maint as pm  # noqa: E402
from repro_torch.core import (CoreMaintainer, CudaBackend, Delete,  # noqa: E402
                              Insert, UpdateBatch, decompose, warm_settle)
from repro_torch.core.imcore import imcore_bz  # noqa: E402
from repro_torch.graph import BufferedGraph, CSRGraph  # noqa: E402
from repro_torch.graph.update_cases import families, light_batch  # noqa: E402
from repro_torch.interop import (buffered_from, csr_from,  # noqa: E402
                                 maintainer_state_from, update_batch_from)
from repro_torch import runtime  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.runtime import Settings  # noqa: E402

from test_parallel_maint import (FAMILIES, _graph, _live_edges,  # noqa: E402
                                 _rand_missing)

#: port substrate -> the maintainer's backend arguments
SUBSTRATES = {
    "numpy": lambda: {"backend": "numpy"},
    "cuda": lambda: {"backend": "cuda", "device": "cpu"},
    "cuda_per_probe": lambda: {"backend": CudaBackend(device="cpu",
                                                      fused=False)},
    "torch": lambda: {"backend": "torch", "device": "cpu"},
}
#: the families the cuda substrates meet pallas-interpret on
PALLAS_FAMILIES = ("cascade_delete", "mixed")
STAT_FIELDS = ("node_computations", "edge_block_reads", "node_table_reads",
               "iterations", "num_changed", "num_deletes", "num_inserts",
               "num_noops", "groups", "largest_group", "fallbacks",
               "settle_passes")


def counterpart(substrate: str, family: str = "") -> str:
    if substrate == "numpy":
        return "numpy"
    if substrate.startswith("cuda") and family in PALLAS_FAMILIES:
        return "pallas-interpret"
    return "xla"


def port_maintainer(g, substrate: str, **kw) -> CoreMaintainer:
    """The port's maintainer on a copy of the reference graph ``g`` (a
    CSRGraph or a BufferedGraph of the JAX package)."""
    bg = buffered_from(g) if isinstance(g, JBuffered) else \
        BufferedGraph(csr_from(g))
    return CoreMaintainer(bg, **SUBSTRATES[substrate](), **kw)


def same_state(port, ref, what=""):
    np.testing.assert_array_equal(port.core, ref.core, err_msg=what)
    np.testing.assert_array_equal(port.cnt, ref.cnt, err_msg=what)


def same_stats(got, want, what=""):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"


def oracle(g, **kw) -> JMaintainer:
    """The reference's serial oracle: per-edge maintenance on numpy."""
    return JMaintainer(g, settings=JSettings(parallel_maint=False), **kw)


# ------------------------------------------------------------- the battery
@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_battery_matches_jax(monkeypatch, family, substrate):
    ref_backend = counterpart(substrate, family)
    if substrate == "cuda_per_probe":
        monkeypatch.setenv("REPRO_PALLAS_FUSED", "0")
    g, n = _graph(ref_backend, seed=11 + len(family))
    batches = FAMILIES[family](g, n, np.random.default_rng(29))
    ser = oracle(JBuffered(g))
    ref = JMaintainer(JBuffered(g), settings=JSettings(backend=ref_backend,
                                                       parallel_maint=True))
    port = port_maintainer(g, substrate)
    same_state(port, ser, "initial state")
    for i, ops in enumerate(batches):
        batch = JBatch(ops)
        ser.apply(batch)
        want = ref.apply(batch)
        got = port.apply(update_batch_from(batch))
        assert got.algorithm.startswith("parallel(")
        same_state(port, ser, f"{family}/{substrate} batch {i}")
        same_stats(got, want, f"{family}/{substrate} batch {i}")
    final = port.bg.materialize()
    np.testing.assert_array_equal(port.core, imcore_bz(final))
    np.testing.assert_array_equal(port.core, jimcore_bz(ref.bg.materialize()))


@pytest.mark.parametrize("family", sorted(families(
    csr_from(chung_lu(40, 120, seed=0)), np.zeros(40, np.int64))))
def test_numpy_drawn_families_match_jax(family):
    """The card's families (graph/update_cases.py) through the port's cuda
    substrate and the reference's serial oracle: the same (core, cnt)."""
    g = chung_lu(300, 1200, seed=31)
    port = port_maintainer(g, "cuda")
    ser = oracle(JBuffered(g))
    for ops in families(port.bg.base, port.core)[family]:
        assert len(ops) and all(u < v for _, u, v in ops)
        port.apply(UpdateBatch.from_wire(ops))
        ser.apply(JBatch.from_wire(ops))
        same_state(port, ser, family)


# ---------------------------------------------- the paper's worked examples
EXAMPLES = {
    # Example 5.1: delete (v0, v1); v0..v3 drop to core 2
    "5.1": ([], Delete(0, 1), "semiinsert*", [2, 2, 2, 2, 2, 2, 2, 2, 1],
            {"iterations": 1, "node_computations": 4, "num_changed": 4}),
    # Example 5.2: then insert (v4, v6) with Algorithm 7
    "5.2": ([Delete(0, 1)], Insert(4, 6), "semiinsert",
            [2, 2, 2, 3, 3, 3, 3, 2, 1], {"node_computations": 12}),
    # Example 5.3: the same insertion with Algorithm 8
    "5.3": ([Delete(0, 1)], Insert(4, 6), "semiinsert*",
            [2, 2, 2, 3, 3, 3, 3, 2, 1],
            {"node_computations": 5, "iterations": 2, "num_changed": 4}),
}


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_paper_examples_on_the_per_edge_path(example):
    before, op, algo, want_core, want = EXAMPLES[example]
    serial = Settings(backend="numpy", parallel_maint=False)
    port = CoreMaintainer(csr_from(paper_example_graph()), block_edges=16,
                          settings=serial)
    ref = oracle(paper_example_graph(), block_edges=16)
    for b in before:
        port.apply(UpdateBatch([b]))
        ref.apply(update_batch_jax([b]))
    got = port.apply(UpdateBatch([op]), insert_algorithm=algo)
    exp = ref.apply(update_batch_jax([op]), insert_algorithm=algo)
    assert got.algorithm == f"batch({algo})"
    np.testing.assert_array_equal(port.core, want_core)
    for f, v in want.items():
        assert getattr(got, f) == v, f
    # the exact cnt trace: the reference's, and Eq. 2 of the new cores
    same_state(port, ref, example)
    same_stats(got, exp, example)
    g = port.bg.materialize()
    eq2 = [int((port.core[g.neighbors(v)] >= port.core[v]).sum())
           for v in range(g.n)]
    np.testing.assert_array_equal(port.cnt, eq2)


def update_batch_jax(ops) -> JBatch:
    return JBatch.from_wire(UpdateBatch(ops).to_wire())


# ------------------------------------------- random streams and round trips
@pytest.mark.parametrize("algorithm", ["semiinsert", "semiinsert*"])
def test_random_update_stream_matches_recompute_and_jax(algorithm):
    rng = np.random.default_rng(0)
    g = erdos_renyi(200, 600, seed=4)
    serial = Settings(backend="numpy", parallel_maint=False)
    port = CoreMaintainer(csr_from(g), block_edges=64, settings=serial)
    ref = oracle(g, block_edges=64)
    present = {tuple(e) for e in g.edge_list().tolist()}
    for step in range(60):
        if present and rng.random() < 0.5:
            u, v = list(present)[rng.integers(len(present))]
            op = Delete(int(u), int(v))
            present.discard((u, v))
        else:
            while True:
                u, v = int(rng.integers(200)), int(rng.integers(200))
                lo, hi = min(u, v), max(u, v)
                if u != v and (lo, hi) not in present:
                    break
            op = Insert(lo, hi)
            present.add((lo, hi))
        got = port.apply(UpdateBatch([op]), insert_algorithm=algorithm)
        want = ref.apply(update_batch_jax([op]), insert_algorithm=algorithm)
        same_state(port, ref, f"step {step}")
        same_stats(got, want, f"step {step}")
        # both flush, so both charge the same block layout next step
        ref.bg.materialize()
        np.testing.assert_array_equal(port.core,
                                      imcore_bz(port.bg.materialize()),
                                      err_msg=f"step {step}")


@pytest.mark.parametrize("algorithm", ["semiinsert", "semiinsert*"])
def test_insert_then_delete_round_trip(algorithm):
    """Thm 3.1: inserting a non-edge and deleting it again restores the
    decomposition, on seeded random small graphs."""
    serial = Settings(backend="numpy", parallel_maint=False)
    for seed in range(24):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(3, 40))
        edges = rng.integers(0, n, size=(int(rng.integers(1, 80)), 2))
        g = CSRGraph.from_edges(n, edges)
        if g.m == 0:
            continue
        m = CoreMaintainer(g, block_edges=8, settings=serial)
        core0, cnt0 = m.core.copy(), m.cnt.copy()
        present = set(map(tuple, g.edge_list().tolist()))
        non_edges = [(a, b) for a in range(n) for b in range(a + 1, n)
                     if (a, b) not in present]
        if not non_edges:
            continue
        a, b = non_edges[int(rng.integers(len(non_edges)))]
        m.apply(UpdateBatch([Insert(a, b)]), insert_algorithm=algorithm)
        np.testing.assert_array_equal(m.core, imcore_bz(m.bg.materialize()))
        m.apply(UpdateBatch([Delete(a, b)]))
        np.testing.assert_array_equal(m.core, core0, err_msg=f"seed {seed}")
        np.testing.assert_array_equal(m.cnt, cnt0, err_msg=f"seed {seed}")


# ---------------------------------------------------------------- edge cases
DEVICE_SUBSTRATES = ("cuda", "torch")


@pytest.mark.parametrize("substrate", DEVICE_SUBSTRATES)
def test_net_noop_batch_restores_the_state(substrate):
    """delete(e) then insert(e) in one batch: the graph round-trips."""
    g = chung_lu(200, 800, seed=5)
    port = port_maintainer(g, substrate)
    ref = JMaintainer(JBuffered(g), backend="xla")
    core0, cnt0 = port.core.copy(), port.cnt.copy()
    live = sorted(_live_edges(g))[:12]
    ops = [Delete(*e) for e in live] + [Insert(*e) for e in live]
    same_stats(port.apply(UpdateBatch(ops)), ref.apply(update_batch_jax(ops)))
    np.testing.assert_array_equal(port.core, core0)
    np.testing.assert_array_equal(port.cnt, cnt0)


@pytest.mark.parametrize("substrate", DEVICE_SUBSTRATES)
def test_duplicate_and_missing_ops_are_noops(substrate):
    g = chung_lu(200, 800, seed=7)
    port = port_maintainer(g, substrate)
    ser = oracle(JBuffered(g))
    e = _rand_missing(np.random.default_rng(0), 200, _live_edges(g))
    ops = [Insert(*e), Insert(*e), Delete(199, 198 if e != (198, 199) else 0)]
    s = port.apply(UpdateBatch(ops))
    ser.apply(update_batch_jax(ops))
    assert s.num_noops >= 1
    same_state(port, ser)
    empty = port.apply(UpdateBatch())
    assert empty.num_deletes == empty.num_inserts == 0
    same_state(port, ser)


@pytest.mark.parametrize("substrate", DEVICE_SUBSTRATES)
def test_edges_among_isolated_nodes(substrate):
    base = erdos_renyi(60, 150, seed=3)
    g = type(base).from_edges(base.n + 6, base.edge_list())
    port = port_maintainer(g, substrate)
    ser = oracle(JBuffered(g))
    iso = list(range(base.n, base.n + 6))
    ops = [Insert(iso[0], iso[1]), Insert(iso[1], iso[2]),
           Insert(iso[2], iso[0]), Insert(iso[3], 0)]
    port.apply(UpdateBatch(ops))
    ser.apply(update_batch_jax(ops))
    same_state(port, ser)


@pytest.mark.parametrize("substrate", DEVICE_SUBSTRATES)
def test_group_cap_forces_serial_fallback_and_stays_exact(substrate):
    g = chung_lu(200, 800, seed=9)
    port = port_maintainer(g, substrate, group_cap=1)
    ref = JMaintainer(JBuffered(g), backend="xla", group_cap=1)
    ser = oracle(JBuffered(g))
    rng = np.random.default_rng(1)
    live = _live_edges(g)
    ops = []
    for _ in range(8):
        e = _rand_missing(rng, 200, live)
        live.add(e)
        ops.append(Insert(*e))
    got = port.apply(UpdateBatch(ops))
    want = ref.apply(update_batch_jax(ops))
    ser.apply(update_batch_jax(ops))
    assert got.fallbacks >= 1
    same_stats(got, want)
    same_state(port, ser)


@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_light_batch_settles_without_fallback(substrate):
    """``update_cases.light_batch`` draws its inserts where every candidate
    set stays under the cap, so the grouped settle takes the whole batch,
    deletes and inserts, without the serial fallback, and lands on the
    reference's serial oracle."""
    g = chung_lu(2000, 8000, seed=7)
    r = decompose(csr_from(g), "semicore*", backend="numpy")
    ops = light_batch(csr_from(g), r.core, r.cnt, 16, 16, seed=3, cap=100)
    inserts = sum(k == "+" for k, _, _ in ops)
    assert len(ops) - inserts == 16 and 0 < inserts <= 16
    port = port_maintainer(g, substrate, group_cap=100)
    got = port.apply(UpdateBatch.from_wire(ops))
    assert got.fallbacks == 0 and got.groups > 0 and got.iterations > 0
    assert got.num_inserts == inserts and got.num_noops == 0
    ser = oracle(JBuffered(g))
    ser.apply(JBatch.from_wire(ops))
    same_state(port, ser)


def test_candidate_bound_covers_every_changed_node(monkeypatch):
    """Every node whose core changed lies in some round's plan: a rise in a
    planned candidate set, a drop in a planned delete prefix."""
    g = chung_lu(300, 1200, seed=21)
    port = port_maintainer(g, "cuda")
    core_before = port.core.copy()
    plans = []
    orig_batch, orig_risers = pm.plan_batch, pm.plan_risers

    def rec_batch(*a, **k):
        p = orig_batch(*a, **k)
        plans.append((p, a[1].copy()))  # (plan, round-start core0)
        return p

    def rec_risers(*a, **k):
        p = orig_risers(*a, **k)
        plans.append((p, a[1].copy()))
        return p

    monkeypatch.setattr(pm, "plan_batch", rec_batch)
    monkeypatch.setattr(pm, "plan_risers", rec_risers)
    rng = np.random.default_rng(2)
    live = _live_edges(g)
    ops = []
    for _ in range(24):
        if rng.random() < 0.5 and live:
            e = sorted(live)[int(rng.integers(len(live)))]
            live.discard(e)
            ops.append(Delete(*e))
        else:
            e = _rand_missing(rng, 300, live)
            live.add(e)
            ops.append(Insert(*e))
    assert port.apply(UpdateBatch(ops)).algorithm == "parallel(cuda)"
    assert plans
    covered = np.zeros(300, dtype=bool)
    for plan, core_r in plans:
        for up in plan.updates:
            covered[np.asarray(up.cand, dtype=np.int64)] = True
            if up.prefix_level >= 0:
                covered |= core_r <= up.prefix_level
    stray = np.flatnonzero((port.core != core_before) & ~covered)
    assert stray.size == 0, f"changed outside every plan bound: {stray[:10]}"


@pytest.mark.parametrize("raw,parallel", [("0", False), ("off", False),
                                          ("No", False), ("1", True),
                                          ("yes", True), ("", True)])
def test_parallel_maint_env_toggle(monkeypatch, raw, parallel):
    g = csr_from(chung_lu(150, 600, seed=10))
    monkeypatch.setenv("REPRO_TORCH_PARALLEL_MAINT", raw)
    m = CoreMaintainer(g, backend="torch", device="cpu",
                       settings=Settings(parallel_maint=not parallel))
    s = m.apply(UpdateBatch.from_pairs([], [(0, 149)]))
    assert s.algorithm == ("parallel(torch)" if parallel
                           else "batch-settle(torch)")
    m = CoreMaintainer(g, backend="numpy")
    s = m.apply(UpdateBatch.from_pairs([(0, 149)], []))
    assert s.algorithm == ("parallel(numpy)" if parallel
                           else "batch(semiinsert*)")


@pytest.mark.parametrize("off_by", ["env", "settings"])
def test_device_resident_off_takes_the_host_settle(monkeypatch, off_by):
    """REPRO_TORCH_DEVICE_RESIDENT=0, or ``Settings(device_resident=False)``
    with the variable unset: the grouped settle's round runs the host seq
    settle, as the reference's does without residency."""
    g = chung_lu(250, 1000, seed=12)
    batches = FAMILIES["delete_sparse"](g, 250, np.random.default_rng(29))
    monkeypatch.setenv("REPRO_DEVICE_RESIDENT", "0")
    if off_by == "env":
        monkeypatch.setenv("REPRO_TORCH_DEVICE_RESIDENT", "0")
        port = port_maintainer(g, "cuda")
    else:
        monkeypatch.delenv("REPRO_TORCH_DEVICE_RESIDENT", raising=False)
        port = port_maintainer(g, "cuda",
                               settings=Settings(device_resident=False))
    builds = port.backend.structure_builds  # the per-pass decomposition's
    ref = JMaintainer(JBuffered(g), backend="xla")
    for ops in batches:
        got = port.apply(update_batch_from(JBatch(ops)))
        want = ref.apply(JBatch(ops))
        assert got.settle_passes > 0
        same_state(port, ref)
        same_stats(got, want)
    # the graph changed, and no settle bound the device structure again
    assert port.backend.structure_builds == builds


# ---------------------------------------------------- structure and buffer
def test_noop_batch_rebuilds_no_structure():
    g = chung_lu(300, 1200, seed=6)
    port = port_maintainer(g, "cuda")
    ops = UpdateBatch([Delete(*e) for e in sorted(_live_edges(g))[:5]])
    port.apply(ops)
    warm_settle(port.engine, port.core, 0, port.backend)  # binds this version
    version, builds = port.bg.version, port.backend.structure_builds
    s = port.apply(ops)  # every op a no-op now
    assert s.num_noops == 5 and port.bg.version == version
    r = warm_settle(port.engine, port.core, 0, port.backend)
    assert port.backend.structure_builds == builds
    np.testing.assert_array_equal(r.core, port.core)
    # a batch that changes the graph rebuilds it once
    port.apply(UpdateBatch([Insert(*e) for e in ops.deletes]))
    warm_settle(port.engine, port.core, 0, port.backend)
    assert port.backend.structure_builds == builds + 1


@pytest.mark.parametrize("substrate", ["numpy", "cuda", "torch"])
def test_batches_across_the_buffer_flush_match_jax(substrate):
    """A buffer of 40 updates fills mid-batch and rewrites the base CSR
    (and with it the block layout the I/O accounting charges)."""
    g = chung_lu(250, 1000, seed=14)
    rng = np.random.default_rng(8)
    live = _live_edges(g)
    ref_backend = counterpart(substrate)
    ref = JMaintainer(JBuffered(g, buffer_capacity=40), backend=ref_backend)
    port = CoreMaintainer(BufferedGraph(csr_from(g), buffer_capacity=40),
                          **SUBSTRATES[substrate]())
    base0 = port.bg.base
    for _ in range(3):
        ops = []
        for _ in range(20):
            if rng.random() < 0.5:
                e = sorted(live)[int(rng.integers(len(live)))]
                live.discard(e)
                ops.append(Delete(*e))
            else:
                e = _rand_missing(rng, 250, live)
                live.add(e)
                ops.append(Insert(*e))
        got = port.apply(UpdateBatch(ops))
        want = ref.apply(update_batch_jax(ops))
        same_state(port, ref)
        same_stats(got, want)
    assert port.bg.base is not base0 and port.bg._size == 20
    np.testing.assert_array_equal(port.bg.base.indptr, ref.bg.base.indptr)
    np.testing.assert_array_equal(port.bg.base.adj, ref.bg.base.adj)


@pytest.mark.parametrize("substrate,ref_backend", [("numpy", "numpy"),
                                                   ("torch", "xla")])
def test_state_carried_mid_stream(substrate, ref_backend):
    """A reference maintainer mid-stream, buffer not empty, carried into
    the port: both apply the next batches alike."""
    g = chung_lu(250, 1000, seed=15)
    batches = FAMILIES["mixed"](g, 250, np.random.default_rng(3))
    ref = JMaintainer(JBuffered(g), backend=ref_backend)
    ref.apply(JBatch(batches[0]))
    assert ref.bg._size
    bg, core, cnt = maintainer_state_from(ref)
    port = CoreMaintainer(bg, state=(core, cnt), **SUBSTRATES[substrate]())
    same_state(port, ref)
    for ops in batches[1:] + FAMILIES["reinsert"](g, 250,
                                                  np.random.default_rng(4)):
        got = port.apply(update_batch_from(JBatch(ops)))
        want = ref.apply(JBatch(ops))
        same_state(port, ref)
        for f in STAT_FIELDS:
            if f not in ("edge_block_reads", "node_table_reads"):
                assert getattr(got, f) == getattr(want, f), f


def test_default_maintainer_needs_a_gpu(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = csr_from(paper_example_graph())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoreMaintainer(g)
    m = CoreMaintainer(g, device="cpu")
    assert m.backend.name == "cuda" and m.backend.device.type == "cpu"
    np.testing.assert_array_equal(m.core, [3, 3, 3, 3, 2, 2, 2, 2, 1])


# ------------------------------------------------ copies of host modules
def test_update_copy_matches_reference():
    pairs = ([(0, 1), (2, 3)], [(4, 5), (1, 0)])
    port, ref = UpdateBatch.from_pairs(*pairs), JBatch.from_pairs(*pairs)
    assert port.to_wire() == ref.to_wire()
    assert UpdateBatch.from_wire(ref.to_wire()) == port
    assert update_batch_from(ref) == port
    assert (port.deletes, port.inserts) == (ref.deletes, ref.inserts)
    assert repr(port) == repr(ref) and len(port) == len(ref) == 4
    assert hash(port) == hash(UpdateBatch.from_pairs(*pairs))
    assert port != UpdateBatch.from_pairs(*pairs[::-1])
    assert not UpdateBatch() and bool(port)
    assert [op.edge() for op in port] == [op.edge() for op in ref]
    assert (Insert.kind, Delete.kind) == (jupdate.Insert.kind,
                                         jupdate.Delete.kind)
    with pytest.raises(TypeError, match="Insert/Delete"):
        UpdateBatch([(0, 1)])


def test_count_buckets_copy_matches_reference():
    assert metrics.DEFAULT_COUNT_BUCKETS == jmetrics.DEFAULT_COUNT_BUCKETS
    hist = metrics.get_registry()._families[
        "repro_maintenance_group_size_nodes"]
    assert hist.bucket_bounds == tuple(metrics.DEFAULT_COUNT_BUCKETS)


@pytest.mark.parametrize("raw", ["0", "false", " OFF ", "no", "1", "on",
                                 "yes", "", "2"])
def test_settings_knob_parsing_matches_reference(monkeypatch, raw):
    monkeypatch.setenv("REPRO_TORCH_PARALLEL_MAINT", raw)
    assert runtime.setting("parallel_maint") == jparse_flag(raw)
    assert runtime.get_settings().parallel_maint == jparse_flag(raw)


def test_settings_snapshot(monkeypatch):
    for var in runtime.ENV_VARS.values():
        monkeypatch.delenv(var, raising=False)
    s = runtime.get_settings()
    assert s == Settings() == Settings(backend="cuda", device_resident=True,
                                       resident_chunk=8, parallel_maint=True)
    assert runtime.get_settings(backend="torch").backend == "torch"
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "numpy")
    assert runtime.get_settings(backend="torch").backend == "numpy"
    with pytest.raises(TypeError, match="unknown settings"):
        runtime.get_settings(pallas_fused=True)
    with pytest.raises(Exception):
        s.backend = "numpy"  # frozen
