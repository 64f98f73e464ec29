"""The port's superstep kernel module against the JAX reference kernel.

On the CPU the port's wrappers run the kernels' plain torch versions; the
JAX side runs its Pallas kernel in interpret mode.  Outputs must be
bit-identical (tolerance 0: all integer) over the block-boundary CASES of
the reference kernel tests: every row of ``fused_pass`` (all three
algorithms), and every frontier row of ``fused_hindex`` and
``fused_counts``.  Off the frontier those two are 0 in the port, as the
reference documents; the reference itself returns 0 or the degree there,
depending on whether its edge tile holds a frontier row.  The CUDA
kernels are held to the plain version in ``test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.graph import CSRGraph as RefCSR  # noqa: E402
from repro.kernels import fused_superstep as jfs  # noqa: E402
from repro.kernels.ref import fused_superstep_ref as jax_ref  # noqa: E402

from repro_torch.core import HostEngine, decompose  # noqa: E402
from repro_torch.core.resident import _edge_pad, build_structure  # noqa: E402
from repro_torch.graph import CSRGraph  # noqa: E402
from repro_torch.interop import csr_from  # noqa: E402
from repro_torch.kernels import fused_superstep as fsk  # noqa: E402
from repro_torch.kernels.cases import CASES, superstep_case  # noqa: E402
from repro_torch.kernels.ref import fused_superstep_ref  # noqa: E402

ALGORITHMS = ("semicore", "semicore+", "semicore*")


def _probes(x) -> int:
    return max(1, math.ceil(math.log2(int(x) + 2)))


def _tensors(c, device="cpu"):
    return {k: torch.as_tensor(v.astype(np.int32) if k == "seg_ptr" else v,
                               device=device) for k, v in c.items()}


def _cases(seed):
    rng = np.random.default_rng(seed)
    for (n, m, tile, iso, frontier) in CASES:
        yield n, tile, frontier, superstep_case(n, m, iso, frontier, rng)


def _assert_same(got, want, what, rows=None):
    got, want = np.asarray(got.cpu()), np.asarray(want)
    if rows is not None:
        assert not got[~rows].any(), f"{what}: nonzero off the frontier"
        got, want = got[rows], want[rows]
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------- kernel module vs JAX
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_pass_matches_jax_kernel(algorithm):
    for n, tile, frontier, c in _cases(0):
        ft = jfs.build_fused_table(c["seg_ptr"], c["nbr"], n, tile)
        cmax = c["core"][c["active"]].max() if c["active"].any() else 0
        want = jfs.fused_pass(
            jnp.asarray(c["core"]), jnp.asarray(c["cnt"]),
            jnp.asarray(c["active"]), ft.arrays, dims=ft.dims,
            num_probes=_probes(cmax), algorithm=algorithm, interpret=True)
        t = _tensors(c)
        got = fsk.fused_pass(t["core"], t["cnt"], t["active"], t["seg_ptr"],
                             t["nbr"], algorithm=algorithm)
        for name, g_, w_ in zip(("core2", "cnt2", "active2", "upd"), got,
                                want):
            _assert_same(g_, w_, f"{algorithm}/{frontier} n={n} {name}")
            if name != "active2":
                assert g_.dtype == torch.int32


def test_fused_hindex_matches_jax_kernel():
    for n, tile, frontier, c in _cases(1):
        ft = jfs.build_fused_table(c["seg_ptr"], c["nbr"], n, tile)
        cmax = c["core"][c["active"]].max() if c["active"].any() else 0
        want = jfs.fused_hindex(jnp.asarray(c["core"]),
                                jnp.asarray(c["active"]), ft.arrays,
                                dims=ft.dims, num_probes=_probes(cmax),
                                interpret=True)
        t = _tensors(c)
        got = fsk.fused_hindex(t["core"], t["active"], t["seg_ptr"], t["nbr"])
        for name, g_, w_ in zip(("h", "cnt_at_h"), got, want):
            _assert_same(g_, w_, f"hindex/{frontier} n={n} {name}",
                         c["active"])


def test_fused_counts_matches_jax_kernel():
    for n, tile, frontier, c in _cases(2):
        ft = jfs.build_fused_table(c["seg_ptr"], c["nbr"], n, tile)
        want = jfs.fused_counts(
            jnp.asarray(c["core"]), jnp.asarray(c["thr"]),
            jnp.asarray(c["active"]), ft.arrays, dims=ft.dims,
            num_probes=_probes(c["thr"].max()), interpret=True)
        t = _tensors(c)
        got = fsk.fused_counts(t["core"], t["thr"], t["active"],
                               t["seg_ptr"], t["nbr"])
        _assert_same(got, want, f"counts/{frontier} n={n}", c["active"])


def _rand_csr(n, m, rng, iso_frac=0.0):
    """The reference kernel tests' random multigraph CSR: not symmetric."""
    deg = rng.integers(0, max(1, 2 * m // max(n, 1)), size=n)
    if iso_frac:
        deg[rng.random(n) < iso_frac] = 0
    seg_ptr = np.zeros(n + 1, dtype=np.int64)
    seg_ptr[1:] = np.cumsum(deg)
    pres = np.flatnonzero(deg > 0)
    if len(pres) == 0:
        return seg_ptr, np.zeros(0, np.int32)
    return seg_ptr, rng.choice(pres, size=int(seg_ptr[-1])).astype(np.int32)


def test_row_pass_modes_match_jax_on_asymmetric_tables():
    """The row pass is per row: on the reference tests' own asymmetric
    draws the modes without a push (semicore, hindex, counts) still match
    the JAX kernel bit for bit."""
    rng = np.random.default_rng(3)
    for (n, m, tile, iso, frontier) in CASES:
        seg_ptr, nbr = _rand_csr(n, m, rng, iso)
        deg = np.diff(seg_ptr)
        core = np.minimum(deg, rng.integers(0, 12, size=n)).astype(np.int32)
        core = np.where(deg > 0, np.maximum(core, 1), 0).astype(np.int32)
        active = (core > 0) & (rng.random(n) < 0.6)
        thr = np.where(active, rng.integers(0, 12, size=n), 0).astype(np.int32)
        cmax = core[active].max() if active.any() else 0
        ft = jfs.build_fused_table(seg_ptr, nbr, n, tile)
        jc, ja = jnp.asarray(core), jnp.asarray(active)
        sp = torch.as_tensor(seg_ptr.astype(np.int32))
        tn, tc, ta = (torch.as_tensor(x) for x in (nbr, core, active))
        want = jfs.fused_pass(jc, jc, ja, ft.arrays, dims=ft.dims,
                              num_probes=_probes(cmax),
                              algorithm="semicore", interpret=True)
        got = fsk.fused_pass(tc, tc, ta, sp, tn, algorithm="semicore")
        _assert_same(got[0], want[0], f"semicore n={n}")
        _assert_same(got[3], want[3], f"semicore upd n={n}")
        want = jfs.fused_hindex(jc, ja, ft.arrays, dims=ft.dims,
                                num_probes=_probes(cmax), interpret=True)
        got = fsk.fused_hindex(tc, ta, sp, tn)
        _assert_same(got[0], want[0], f"hindex h n={n}", active)
        _assert_same(got[1], want[1], f"hindex cnt n={n}", active)
        want = jfs.fused_counts(jc, jnp.asarray(thr), ja, ft.arrays,
                                dims=ft.dims, num_probes=_probes(thr.max()),
                                interpret=True)
        got = fsk.fused_counts(tc, torch.as_tensor(thr), ta, sp, tn)
        _assert_same(got, want, f"counts n={n}", active)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_torch_oracle_matches_jax_oracle_and_plain_version(algorithm):
    """kernels/ref.py equals the JAX oracle, and the plain version's push
    form equals the oracle's row-summed form on undirected tables."""
    for n, _tile, frontier, c in _cases(4):
        args = (c["core"], c["cnt"], c["active"], c["nbr"], c["rows"], n,
                algorithm)
        want = jax_ref(*args)
        oracle = fused_superstep_ref(*args)
        t = _tensors(c)
        plain = fsk.fused_pass_plain(t["core"], t["cnt"], t["active"],
                                     t["seg_ptr"], t["nbr"],
                                     algorithm=algorithm)
        for name, o_, p_, w_ in zip(("core2", "cnt2", "active2", "upd"),
                                    oracle, plain, want):
            _assert_same(o_, w_, f"oracle {algorithm}/{frontier} {name}")
            _assert_same(p_, w_, f"plain {algorithm}/{frontier} {name}")


# --------------------------------------------------------- trap pins
def _isolated_zero_graph():
    """Node 0 isolated, E = 2 * 11 = 22 directed edges (not a power of 2)."""
    edges = np.array([(1, 2), (2, 3), (3, 4), (4, 1), (1, 3), (5, 6), (6, 7),
                      (7, 5), (8, 1), (8, 2), (8, 3)])
    return edges


def test_pad_edges_never_reach_node_0():
    edges = _isolated_zero_graph()
    g = CSRGraph.from_edges(9, edges)
    E = g.num_directed
    assert E == 22 and _edge_pad(E) == 32
    rs = build_structure(HostEngine(g, block_edges=8).planner, "cpu")
    assert rs.E_pad == 32 and rs.nbr.shape[0] == 32
    assert torch.all(rs.nbr[E:] == 0)           # pads name node 0 ...
    segptr, nbr = rs.edge_table()
    assert nbr.shape[0] == E                      # ... and are never handed on
    all_active = torch.ones(9, dtype=torch.bool)
    core = torch.as_tensor(g.degrees().astype(np.int32))
    cnt = fsk.fused_counts(core, torch.zeros_like(core), all_active, segptr,
                           nbr)
    assert int(cnt[0]) == 0
    from repro.core import decompose as jdecompose

    want = jdecompose(RefCSR.from_edges(9, edges), "semicore*", "batch",
                      block_edges=8, backend="pallas-interpret")
    got = decompose(g, "semicore*", "batch", block_edges=8, device="cpu")
    assert got.core[0] == 0 and got.cnt[0] == 0
    np.testing.assert_array_equal(got.core, want.core)
    np.testing.assert_array_equal(got.cnt, want.cnt)


def test_out_of_range_neighbour_ids_raise_instead_of_clipping():
    c = superstep_case(20, 60, 0.0, "all", np.random.default_rng(5))
    bad = c["nbr"].copy()
    bad[0] = 20  # one past the last node
    # jnp clips the gather and returns quietly ...
    jax_ref(c["core"], c["cnt"], c["active"], bad, c["rows"], 20, "semicore*")
    # ... the port's plain version raises
    t = _tensors(c)
    with pytest.raises(IndexError):
        fsk.fused_pass(t["core"], t["cnt"], t["active"], t["seg_ptr"],
                       torch.as_tensor(bad), algorithm="semicore*")
    # and a structure with such an id is refused before any kernel runs
    g = CSRGraph(indptr=c["seg_ptr"], adj=bad)
    with pytest.raises(ValueError, match="neighbour ids"):
        build_structure(HostEngine(g).planner, "cpu")


def test_int64_inputs_are_refused_and_state_stays_int32():
    c = superstep_case(20, 60, 0.0, "all", np.random.default_rng(6))
    t = _tensors(c)
    with pytest.raises(TypeError, match="int32"):
        fsk.fused_pass(t["core"].long(), t["cnt"], t["active"], t["seg_ptr"],
                       t["nbr"], algorithm="semicore*")
    with pytest.raises(TypeError, match="int32"):
        fsk.fused_counts(t["core"], t["thr"].long(), t["active"],
                         t["seg_ptr"], t["nbr"])
    rs = build_structure(HostEngine(CSRGraph(c["seg_ptr"], c["nbr"])).planner,
                         "cpu")
    assert rs.segptr.dtype == rs.nbr.dtype == torch.int32
    out = fsk.fused_pass(t["core"], t["cnt"], t["active"], t["seg_ptr"],
                         t["nbr"], algorithm="semicore*")
    assert out[0].dtype == out[1].dtype == out[3].dtype == torch.int32
    r = decompose(CSRGraph(c["seg_ptr"], c["nbr"]), "semicore*",
                  device="cpu")
    assert r.core.dtype == r.cnt.dtype == np.int64


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    before = dict(fsk.LAUNCHES)
    decompose(csr_from(RefCSR.from_edges(9, _isolated_zero_graph())),
              "semicore+", device="cpu")
    assert fsk.LAUNCHES == before
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fsk.row_pass(fsk.MODE_HINDEX, torch.zeros(4, dtype=torch.int32,
                                                  device="meta"),
                     meta, meta, None, meta.bool())
