"""The fused superstep kernels' bin rule and work-list layout, on the CPU.

``degree_bin`` (Python) decides which kernel of ``csrc/fused_superstep.cu``
takes a row; the source mirrors it and the wrapper checks the source's
constants when it loads the library.  The tests pin the rule at every bin
boundary and at degree 0, the mirror, the wrapper's check, the list
layout of ``bin_plan``, and the kernels' histogram arithmetic (replayed
here lane by lane) against the plain version's binary search.  The
kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_superstep as fsk  # noqa: E402
from repro_torch.kernels.cases import (BIN_DEGREES, CASES,  # noqa: E402
                                       binned_case, superstep_case)

SOURCE = Path(fsk.__file__).resolve().parent / "csrc" / "fused_superstep.cu"

# (degree, bin): 0 has no bin; each boundary -1, at, +1
RULE = [(0, -1), (1, 0), (2, 0), (31, 0), (32, 0), (33, 1), (34, 1),
        (511, 1), (512, 1), (513, 2), (514, 2), (8190, 2), (8191, 2),
        (8192, 3), (8193, 3), (1_000_000, 3)]


@pytest.mark.parametrize("deg,want", RULE)
def test_degree_bin_at_every_boundary(deg, want):
    assert fsk.degree_bin(deg) == want
    t = torch.tensor([deg], dtype=torch.int32)
    assert fsk.degree_bin(t).tolist() == [want]


def test_rule_boundaries_follow_the_constants():
    first = fsk.BIN_FIRST_DEGREE
    assert first == (1, fsk.GROUP_MAX_DEG + 1, fsk.WARP_MAX_DEG + 1,
                     fsk.HIST_BINS)
    assert len(first) == fsk.BINS
    # every bin-2 row's histogram (cap + 1 <= deg + 1 bins) fits HIST_BINS
    assert fsk.degree_bin(fsk.HIST_BINS - 1) == 2
    # a bin-0 row has at most GROUP_MAX_DEG / GROUP_LANES edges a lane
    assert fsk.GROUP_MAX_DEG % fsk.GROUP_LANES == 0


def _source_constant(text, name):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"no constant {name} in {SOURCE.name}"
    return int(m.group(1))


def test_source_mirrors_the_rule():
    text = SOURCE.read_text()
    got = [_source_constant(text, k) for k in
           ("kGroupLanes", "kGroupMaxDeg", "kWarpMaxDeg", "kHistBins")]
    fsk.check_bin_rule(got)
    assert _source_constant(text, "kBins") == fsk.BINS
    # the source's degree_bin compares against the same constants
    body = text[text.index("int degree_bin(int deg)"):]
    body = body[:body.index("}")]
    assert re.findall(r"deg (<=?) (\w+)", body) == [
        ("<=", "0"), ("<=", "kGroupMaxDeg"), ("<=", "kWarpMaxDeg"),
        ("<", "kHistBins")]


@pytest.mark.parametrize("index", range(4))
def test_wrapper_refuses_a_source_of_another_rule(index):
    got = [fsk.GROUP_LANES, fsk.GROUP_MAX_DEG, fsk.WARP_MAX_DEG,
           fsk.HIST_BINS]
    got[index] += 1
    with pytest.raises(RuntimeError, match="bin rule"):
        fsk.check_bin_rule(got)


def test_bin_plan_lays_out_each_bin():
    rng = np.random.default_rng(0)
    deg = np.concatenate([np.array([d for d, _ in RULE]),
                          rng.integers(0, 600, size=500)])
    segptr = np.zeros(len(deg) + 1, dtype=np.int64)
    segptr[1:] = np.cumsum(deg)
    plan = fsk.bin_plan(torch.as_tensor(segptr.astype(np.int32)))
    assert plan.dtype == torch.int32 and tuple(plan.shape) == (fsk.BINS + 1,)
    bins = np.array([fsk.degree_bin(int(d)) for d in deg])
    want = np.concatenate([[0], np.cumsum([(bins == b).sum()
                                           for b in range(fsk.BINS)])])
    np.testing.assert_array_equal(plan.numpy(), want)
    assert plan[-1] == (deg > 0).sum()


def test_binned_case_has_a_row_at_every_boundary():
    rng = np.random.default_rng(0)
    c = binned_case(rng)
    deg = np.diff(c["seg_ptr"])
    assert set(BIN_DEGREES) <= set(deg.tolist())
    assert {fsk.degree_bin(int(d)) for d in deg} == {-1, 0, 1, 2, 3}
    # undirected: every edge in both endpoint lists
    rows = np.repeat(np.arange(len(deg)), deg)
    fwd = np.sort(rows.astype(np.int64) * len(deg) + c["nbr"])
    bwd = np.sort(c["nbr"].astype(np.int64) * len(deg) + rows)
    np.testing.assert_array_equal(fwd, bwd)


# ------------------------------------- the kernels' histogram arithmetic
def _histogram_h(vals, core_v, lanes):
    """The row kernels' h and cnt, step for step: capped values into cap +
    1 bins, suffix counts in place by ``lanes`` contiguous runs, h = the
    count of feasible k in [1, cap], cnt = suffix[h]."""
    deg = len(vals)
    cap = max(0, min(core_v, deg))
    hist = np.zeros(cap + 1, dtype=np.int64)
    for x in vals:
        hist[cap if x >= cap else max(x, 0)] += 1
    nb = cap + 1
    per = -(-nb // lanes)
    runs = [(min(g * per, nb), min(min(g * per, nb) + per, nb))
            for g in range(lanes)]
    sums = [hist[b0:b1].sum() for b0, b1 in runs]
    feas = 0
    out = hist.copy()
    for g, (b0, b1) in enumerate(runs):
        run = sum(sums[g + 1:])
        for b in range(b1 - 1, b0 - 1, -1):
            run += hist[b]
            out[b] = run
            feas += (b >= 1) and (run >= b)
    return feas, int(out[feas])


@pytest.mark.parametrize("lanes", [fsk.GROUP_LANES, 32, 256])
def test_histogram_arithmetic_matches_the_binary_search(lanes):
    rng = np.random.default_rng(lanes)
    n_rows = 0
    for (n, m, _tile, iso, frontier) in CASES:
        c = superstep_case(n, m, iso, "all", rng)
        # cores off their degrees too, some negative, to move every cap
        c["core"] = rng.integers(-1, 40, size=n).astype(np.int32)
        t = {k: torch.as_tensor(v.astype(np.int32) if k == "seg_ptr" else v)
             for k, v in c.items()}
        h, cnt, _ = fsk.row_pass_plain(fsk.MODE_HINDEX, t["seg_ptr"],
                                       t["nbr"], t["core"], None, t["active"])
        for v in np.flatnonzero(c["active"] & (np.diff(c["seg_ptr"]) > 0)):
            lo, hi = c["seg_ptr"][v], c["seg_ptr"][v + 1]
            got = _histogram_h(c["core"][c["nbr"][lo:hi]], int(c["core"][v]),
                               lanes)
            assert got == (int(h[v]), int(cnt[v])), (n, v)
            n_rows += 1
    assert n_rows > 100


def test_plan_keyword_leaves_the_plain_route_unchanged():
    rng = np.random.default_rng(3)
    c = superstep_case(50, 200, 0.0, "rand", rng)
    t = {k: torch.as_tensor(v.astype(np.int32) if k == "seg_ptr" else v)
         for k, v in c.items()}
    plan = fsk.bin_plan(t["seg_ptr"])
    args = (t["core"], t["cnt"], t["active"], t["seg_ptr"], t["nbr"])
    for algo in ("semicore", "semicore+", "semicore*"):
        got = fsk.fused_pass(*args, algorithm=algo, plan=plan)
        want = fsk.fused_pass_plain(*args, algorithm=algo)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), algo


def test_probe_graph_is_a_simple_undirected_csr():
    """The timing probe's Chung-Lu graph (drawn with torch, on the card
    there; on the CPU here): symmetric, no self loop, no parallel edge,
    the degree spread of the host generator at the same size."""
    from repro_torch.graph import CSRGraph, powerlaw_chunks
    from repro_torch.kernels.probe_superstep import chung_lu_on_card

    n, m = 20_000, 150_000
    segptr, nbr = chung_lu_on_card(torch.device("cpu"), n, m, 2.5)
    seg = segptr.numpy().astype(np.int64)
    deg = np.diff(seg)
    rows = np.repeat(np.arange(n), deg)
    key = rows * n + nbr.numpy()
    assert (rows != nbr.numpy()).all()
    assert (np.diff(key) > 0).all()  # sorted, no duplicate
    np.testing.assert_array_equal(np.sort(nbr.numpy().astype(np.int64) * n
                                          + rows), key)
    host = CSRGraph.from_edges(
        n, np.concatenate(list(powerlaw_chunks(n=n, m=m, gamma=2.5))))
    for q in (50, 90, 99):
        assert abs(np.percentile(deg, q) - np.percentile(host.degrees(), q)) \
            <= 0.1 * np.percentile(host.degrees(), q) + 1
