"""MoE and MLA serving over a ``model`` axis wider than 1 (one data rank),
against the one-device step and the JAX package.

The port's ranks are gloo processes on the CPU
(``torch_pg_ranks.tp_moe_cases``, which imports no JAX), started once per
mesh layout ``(1, M)`` in :data:`LAYOUTS` with every case in that one
start.  Each case is DeepSeek-V3's (MLA, a dense prefix layer, a shared
expert) or Arctic's (GQA, a dense residual MLP) ``reduced()`` config in
float32: ``prefill_32k``; three ``decode_32k`` steps from a seeded cache
whose length starts at one of ``test_torch_tp.start_lengths``; three
``long_500k`` steps from each ``test_torch_tp.long_lengths``.  Every
rank's joined logits and cache pieces are held within 1e-5 of the
one-device step cut by the reference's placements, and the logits within
2e-4 of the reference's bundle jitted with its shardings on 4 forced host
devices.  Every rank routes the same input to the same experts as the
other ranks and as one device; an Arctic prefill whose router is skewed
drops assignments on every rank's experts.  A DeepSeek-V3 decode with the
latent cache's sequence cut over the ranks and no tensor parallelism
(``seq`` alone) shows that the MLA decode takes the split.  The latent
partials' merge is held to one softmax over the whole cache.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.models.params import tree_init, tree_leaves, tree_map  # noqa: E402
from test_torch_tp import (DECODE_STEPS, ONE_DEVICE_TOL,  # noqa: E402
                           REFERENCE_TOL, long_lengths, start_lengths)
from torch_pg_ranks import _RouteSpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
DSV3, ARCTIC = "deepseek-v3-671b", "arctic-480b"
ARCHS = (DSV3, ARCTIC)
LAYOUTS = ((1, 2), (1, 4))
#: Arctic's router columns scaled by SKEW_FACTOR in the skewed case: two
#: experts on each rank of (1, 2) and one on each rank of (1, 4), so every
#: token's top 2 lie among them and each takes more than its capacity
SKEWED_EXPERTS, SKEW_FACTOR = (0, 2, 4, 6), 30.0
SKEWED = f"{ARCTIC}-skewed"


def _layout_name(layout) -> str:
    return "x".join(map(str, layout))


def _T(shape: str) -> int:
    specs = steps.build_step(DSV3, shape, reduced=True).args[2]
    return specs["ckv"][0][2]


def _cases(layout) -> dict:
    _, M = layout
    cases = {}
    for arch in ARCHS:
        cases[f"{arch}|prefill"] = {"arch": arch, "shape": "prefill_32k",
                                    "params": arch}
        for tag, n in start_lengths(_T("decode_32k"), M).items():
            cases[f"{arch}|decode|{tag}"] = {"arch": arch, "params": arch,
                                             "shape": "decode_32k", "len": n}
        for tag, n in long_lengths(_T("long_500k"), M).items():
            cases[f"{arch}|long|{tag}"] = {"arch": arch, "params": arch,
                                           "shape": "long_500k", "len": n}
    cases[f"{ARCTIC}|prefill|skewed"] = {"arch": ARCTIC, "params": SKEWED,
                                         "shape": "prefill_32k"}
    cases[f"{DSV3}|seq|boundary"] = {
        "arch": DSV3, "params": DSV3, "shape": "decode_32k",
        "len": start_lengths(_T("decode_32k"), M)["boundary"],
        "seq_alone": True}
    return cases


def _params() -> dict:
    """Each params name's whole float32 weights, seeded; Arctic's skewed
    copy scales :data:`SKEWED_EXPERTS`' router columns."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        out[arch] = tree_init(tfm.lm_param_specs(cfg),
                              torch.Generator().manual_seed(31 + i))
    skewed = tree_map(lambda t: t.detach().clone(), out[ARCTIC])
    skewed["layers"]["moe"]["router"][..., list(SKEWED_EXPERTS)] *= \
        SKEW_FACTOR
    out[SKEWED] = skewed
    return out


def _inputs(case: dict, seed: int) -> dict:
    """A case's global inputs, seeded with numpy."""
    cfg = get_config(case["arch"]).reduced()
    b = steps.build_step(case["arch"], case["shape"], reduced=True)
    rng = np.random.default_rng(seed)
    if case["shape"] == "prefill_32k":
        (B, S), _ = b.args[1]
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    (B, _), _ = b.args[1]
    caches = {k: torch.as_tensor(rng.normal(size=shape).astype(np.float32))
              for k, (shape, _) in b.args[2].items() if k != "len"}
    caches["len"] = torch.tensor(case["len"], dtype=torch.int32)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)) for _ in range(DECODE_STEPS)]
    return {"tokens": toks, "caches": caches}


def _one_device(params, case, x):
    """The one-device step's logits (each step), final caches, and the
    routes of its MoE layers, the assignments each dropped and its
    output."""
    b = steps.build_step(case["arch"], case["shape"], reduced=True)
    with _RouteSpy() as rs:
        if case["shape"] == "prefill_32k":
            out = {"logits": [b.fn(params, x["tokens"])]}
        else:
            caches = {k: v.clone() for k, v in x["caches"].items()}
            logits = []
            for tok in x["tokens"]:
                lg, caches = b.fn(params, tok, caches)
                logits.append(lg)
            out = {"logits": logits, "caches": caches}
    out["routes"], out["dropped"] = rs.routes, rs.dropped
    out["moe_out"] = rs.outputs
    return out


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) >= 4
from repro.launch.mesh import use_mesh
from repro.launch.steps import build_step

case_dir, out = sys.argv[1], sys.argv[2]
layouts = json.load(open(f"{case_dir}/layouts.json"))

def nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return tree

params = {}
for lname, (D, M) in layouts.items():
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    cases = json.load(open(f"{case_dir}/{lname}/cases.json"))
    fns, res = {}, {}
    for name, case in cases.items():
        if case.get("seq_alone"):
            continue
        arch, shape, pname = case["arch"], case["shape"], case["params"]
        if pname not in params:
            with np.load(f"{case_dir}/{pname}.npz") as z:
                params[pname] = nest({k: z[k] for k in z.files})
        if (arch, shape) not in fns:
            b = build_step(arch, shape, mesh, reduced=True)
            fns[arch, shape] = jax.jit(b.fn, in_shardings=b.in_shardings,
                                       out_shardings=b.out_shardings)
        fn, p = fns[arch, shape], params[pname]
        key = name.replace("|", "__")
        with np.load(f"{case_dir}/{lname}/{key}.npz") as z, use_mesh(mesh):
            if shape == "prefill_32k":
                res[f"{key}__0"] = np.asarray(fn(p, jnp.asarray(z["tokens"])))
                continue
            caches = {k[6:]: jnp.asarray(z[k]) for k in z.files
                      if k.startswith("cache_")}
            caches["len"] = jnp.int32(int(z["len"]))
            for i in range(int(z["steps"])):
                logits, caches = fn(p, jnp.asarray(z[f"tok{i}"]), caches)
                res[f"{key}__{i}"] = np.asarray(logits)
    np.savez(f"{out}/{lname}.npz", **res)
print("REFERENCE_TP_MOE_OK")
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The one-device steps, the ranks' runs (one start a layout) and the
    reference's sharded bundles (one subprocess on 4 forced host devices,
    run beside the ranks)."""
    case_dir = tmp_path_factory.mktemp("tp_moe_cases")
    ref_dir = tmp_path_factory.mktemp("tp_moe_reference")
    params = _params()
    for pname, tree in params.items():
        torch.save(tree_map(lambda t: t.detach().clone(), tree),
                   case_dir / f"{pname}.pt")
        np.savez(case_dir / f"{pname}.npz",
                 **{n: t.detach().numpy() for n, t in tree_leaves(tree)})
    one = {}
    for layout in LAYOUTS:
        lname = _layout_name(layout)
        (case_dir / lname).mkdir()
        cases = _cases(layout)
        (case_dir / lname / "cases.json").write_text(json.dumps(cases))
        for seed, (name, case) in enumerate(cases.items()):
            x = _inputs(case, seed)
            torch.save(x, case_dir / lname / f"{name}.pt")
            key = name.replace("|", "__")
            if case["shape"] == "prefill_32k":
                np.savez(case_dir / lname / f"{key}.npz",
                         tokens=x["tokens"].numpy())
            else:
                np.savez(case_dir / lname / f"{key}.npz",
                         len=case["len"], steps=DECODE_STEPS,
                         **{f"cache_{k}": v.numpy()
                            for k, v in x["caches"].items() if k != "len"},
                         **{f"tok{i}": t.numpy()
                            for i, t in enumerate(x["tokens"])})
            one[lname, name] = _one_device(params[case["params"]], case, x)
    (case_dir / "layouts.json").write_text(json.dumps(
        {_layout_name(lo): lo for lo in LAYOUTS}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, case_dir,
                            ref_dir], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    outs = {}
    try:
        for layout in LAYOUTS:
            lname = _layout_name(layout)
            out = tmp_path_factory.mktemp(f"tp_moe_ranks_{lname}")
            run_ranks("torch_pg_ranks:tp_moe_cases", layout[0] * layout[1],
                      backend="gloo",
                      args=[case_dir / lname, case_dir, out, *layout],
                      paths=[TESTS], timeout=600,
                      env={"OMP_NUM_THREADS": "1"})
            outs[lname] = out
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REFERENCE_TP_MOE_OK" in stdout, \
        stderr[-3000:]
    return {"one": one, "outs": outs, "ref": ref_dir, "params": params}


def _records(runs, layout, name) -> list:
    lname = _layout_name(layout)
    return [torch.load(runs["outs"][lname] / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _hold_logits(runs, layout, name, recs, reference=True):
    """Every rank's joined logits against the one-device step (and the
    reference), and its vocab piece against the one-device step's."""
    lname = _layout_name(layout)
    one = runs["one"][lname, name]
    cfg = get_config(name.split("|")[0]).reduced()
    M = layout[1]
    key = name.replace("|", "__")
    z = np.load(runs["ref"] / f"{lname}.npz") if reference else None
    for r, rec in enumerate(recs):
        assert len(rec["logits"]) == len(one["logits"])
        for i, (got, want) in enumerate(zip(rec["logits"], one["logits"])):
            assert got.shape == want.shape
            _close(got, want, ONE_DEVICE_TOL,
                   f"{lname} {name} rank {r} step {i} vs one device")
            if z is not None:
                _close(got, torch.as_tensor(z[f"{key}__{i}"]), REFERENCE_TOL,
                       f"{lname} {name} rank {r} step {i} vs the reference")
        pieces = rec.get("logits_pieces") or [rec.get("logits_piece")]
        if not reference:
            continue
        V = cfg.vocab // M
        c = rec["coords"]["model"]
        for i, piece in enumerate(pieces):
            assert piece.shape == (one["logits"][i].shape[0], 1, V)
            _close(piece, one["logits"][i][..., c * V:(c + 1) * V],
                   ONE_DEVICE_TOL, f"{lname} {name} rank {r} logits piece")


def _hold_routes(runs, layout, name, recs):
    """Every rank's MoE inputs and routes bit for bit the other ranks',
    its routes the one device's."""
    one = runs["one"][_layout_name(layout), name]
    for r, rec in enumerate(recs):
        assert len(rec["routes"]) == len(one["routes"]) > 0, (name, r)
        for i, (x, e) in enumerate(zip(rec["moe_inputs"], rec["routes"])):
            assert torch.equal(x, recs[0]["moe_inputs"][i]), (name, r, i)
            assert torch.equal(e, recs[0]["routes"][i]), (name, r, i)
            assert torch.equal(e, one["routes"][i]), (name, r, i)


def _hold_caches(runs, layout, name, recs):
    """Every rank's cache pieces (the sequence over ``model``) against the
    one-device step's final caches, and ``len``."""
    lname = _layout_name(layout)
    one = runs["one"][lname, name]
    M = layout[1]
    for r, rec in enumerate(recs):
        c = rec["coords"]["model"]
        for key, want in one["caches"].items():
            if key == "len":
                assert int(rec["caches"]["len"]) == int(want)
                continue
            T = want.shape[2]
            piece = rec["caches"][key]
            assert piece.shape == (*want.shape[:2], T // M, *want.shape[3:])
            _close(piece, want[:, :, c * (T // M):(c + 1) * (T // M)],
                   ONE_DEVICE_TOL, f"{lname} {name} rank {r} cache {key}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_moe_prefill_equals_one_device_and_the_reference(moe_runs, arch,
                                                            layout):
    name = f"{arch}|prefill"
    recs = _records(moe_runs, layout, name)
    _hold_logits(moe_runs, layout, name, recs)
    _hold_routes(moe_runs, layout, name, recs)


@pytest.mark.parametrize("start", ["zero", "inside", "boundary", "last"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_moe_decode_equals_one_device_and_the_reference(moe_runs, arch,
                                                           layout, start):
    """Three decode steps: the joined logits of every step, the routes,
    and every rank's cache pieces (GQA k, v; MLA's latent and rope key)
    after them."""
    name = f"{arch}|decode|{start}"
    recs = _records(moe_runs, layout, name)
    _hold_logits(moe_runs, layout, name, recs)
    _hold_routes(moe_runs, layout, name, recs)
    _hold_caches(moe_runs, layout, name, recs)
    T = moe_runs["one"][_layout_name(layout), name]["caches"]["len"]
    assert int(T) == start_lengths(_T("decode_32k"), layout[1])[start] + \
        DECODE_STEPS


def _long_starts():
    return [(layout, arch, tag) for layout in LAYOUTS for arch in ARCHS
            for tag in long_lengths(_T("long_500k"), layout[1])]


@pytest.mark.parametrize("layout,arch,start", _long_starts(),
                         ids=[f"{_layout_name(lo)}-{a}-{t}" for lo, a, t in
                              _long_starts()])
def test_tp_moe_long_500k_equals_one_device_and_the_reference(
        moe_runs, layout, arch, start):
    """Three long_500k steps, the cache sequence cut over every rank:
    held as the decode cases, and each step's entries written on exactly
    one rank."""
    name = f"{arch}|long|{start}"
    recs = _records(moe_runs, layout, name)
    _hold_logits(moe_runs, layout, name, recs)
    _hold_routes(moe_runs, layout, name, recs)
    _hold_caches(moe_runs, layout, name, recs)
    for i in range(DECODE_STEPS):
        assert sum(rec["written"][i] for rec in recs) == 1, (name, i)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_skewed_router_drops_on_every_ranks_experts(moe_runs, layout):
    """Arctic's prefill with a skewed router: in every MoE layer each
    rank's experts get more assignments than their capacity, so the
    stable sort decides which are dropped on every rank; the ranks keep
    the one device's choice (their logits and routes)."""
    name = f"{ARCTIC}|prefill|skewed"
    recs = _records(moe_runs, layout, name)
    _hold_logits(moe_runs, layout, name, recs)
    _hold_routes(moe_runs, layout, name, recs)
    cfg = get_config(ARCTIC).reduced()
    X, M = cfg.moe.num_experts, layout[1]
    for e in moe_runs["one"][_layout_name(layout), name]["routes"]:
        over = (torch.bincount(e.reshape(-1), minlength=X)
                - moe_capacity(cfg.moe, e.shape[0])).clamp(min=0)
        assert all(int(over[r * X // M:(r + 1) * X // M].sum()) > 0
                   for r in range(M)), over


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_mla_decode_takes_its_sequence_split(moe_runs, layout):
    """DeepSeek-V3's decode on whole weights with only the latent cache's
    sequence cut over the ranks (``seq`` without ``tp``): the latent and
    rope key written on the rank that holds ``len`` and every rank's
    logits the one device's over the whole cache."""
    name = f"{DSV3}|seq|boundary"
    recs = _records(moe_runs, layout, name)
    _hold_logits(moe_runs, layout, name, recs, reference=False)
    _hold_caches(moe_runs, layout, name, recs)
    for i in range(DECODE_STEPS):
        assert sum(rec["written"][i] for rec in recs) == 1, (name, i)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_no_expert_or_head_piece_is_gathered_whole(moe_runs, layout):
    """No all-gather in any case's steps takes a weight piece (experts,
    MLA's heads, the shared and dense MLPs) as its input."""
    for name in _cases(layout):
        for r, rec in enumerate(_records(moe_runs, layout, name)):
            assert rec["gathers"] > 0, (name, r)
            assert rec["weight_gathers"] == 0, (name, r)


# ------------------------------------------------------- without ranks
class _RankMesh(Mesh):
    """A mesh seen from rank ``rank``, with no process group: its
    placements cut as that rank's would."""

    def __init__(self, shape, rank: int):
        super().__init__(shape, ("data", "model"))
        self._rank = rank

    @property
    def rank(self) -> int:
        return self._rank


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_pieces_drawn_leaf_by_leaf_equal_the_cut_whole(arch, layout):
    """``local_init`` (each leaf drawn and cut at once) gives every rank
    the pieces ``local_args`` cuts from ``tree_init``'s whole tree, bit
    for bit."""
    cfg = get_config(arch).reduced()
    specs = tfm.lm_param_specs(cfg)
    whole = tree_init(specs, torch.Generator().manual_seed(5))
    for r in range(layout[1]):
        b = steps.build_step(arch, "decode_32k", _RankMesh(layout, r),
                             reduced=True)
        want = steps.local_args(b, whole)[0]
        got = steps.local_init(specs, b.in_shardings[0],
                               torch.Generator().manual_seed(5))
        for (n, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            assert g.shape == w.shape and torch.equal(g, w), (r, n)
        assert any(g.shape != w.shape for (_, g), (_, w) in zip(
            tree_leaves(got), tree_leaves(whole))), r


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 33, 64])
def test_latent_pieces_merge_to_one_softmax(P, n):
    """Each piece's ``latent_partial`` at its offset, stacked and merged,
    is the one-device latent decode's softmax over the whole cache; a
    piece wholly past ``n`` is neutral (max NEG_INF, sum 0, context 0)."""
    rng = np.random.default_rng(P * 100 + n)
    B, T, H, kvl, dr = 2, 64, 3, 16, 8
    qa, qr = (torch.as_tensor(rng.normal(size=(B, 1, H, d)).astype(
        np.float32)) for d in (kvl, dr))
    ckv = torch.as_tensor(rng.normal(size=(B, T, kvl)).astype(np.float32))
    kr = torch.as_tensor(rng.normal(size=(B, T, dr)).astype(np.float32))
    scale = 0.3
    Tp = T // P
    parts = [layers.latent_partial(qa, qr, ckv[:, p * Tp:(p + 1) * Tp],
                                   kr[:, p * Tp:(p + 1) * Tp], n, p * Tp,
                                   scale) for p in range(P)]
    for p, (ml, ctx) in enumerate(parts):
        if n <= p * Tp:
            assert bool((ml[..., 0] == layers.NEG_INF).all())
            assert bool((ml[..., 1] == 0).all()) and bool((ctx == 0).all())
    got = layers.merge_latent(torch.stack([m for m, _ in parts]),
                              torch.stack([c for _, c in parts]))
    s = (torch.einsum("bshk,btk->bhst", qa, ckv)
         + torch.einsum("bshr,btr->bhst", qr, kr)) * scale
    s = torch.where(torch.arange(T) < n, s, layers.NEG_INF)
    want = torch.einsum("bhst,btk->bshk", torch.softmax(s, -1), ckv)
    _close(got, want, 2e-6, f"P={P} n={n}")


def test_latent_merge_subtracts_the_largest_max_first():
    """Scores near 500 (past float32's exp range): the merge weights each
    piece by exp(its max - the largest), so the context stays finite and
    equals the softmax's."""
    rng = np.random.default_rng(3)
    B, T, H, kvl, dr, P = 1, 32, 2, 8, 4, 4
    qa = torch.as_tensor(rng.normal(size=(B, 1, H, kvl)).astype(np.float32))
    qr = torch.zeros((B, 1, H, dr))
    ckv = torch.as_tensor(rng.normal(size=(B, T, kvl)).astype(np.float32))
    kr = torch.zeros((B, T, dr))
    scale = 500.0 / float((qa[..., None, :] * ckv[:, None, None]).sum(-1)
                          .amax())
    Tp = T // P
    parts = [layers.latent_partial(qa, qr, ckv[:, p * Tp:(p + 1) * Tp],
                                   kr[:, p * Tp:(p + 1) * Tp], T, p * Tp,
                                   scale) for p in range(P)]
    assert float(torch.stack([m for m, _ in parts])[..., 0].amax()) > 400
    got = layers.merge_latent(torch.stack([m for m, _ in parts]),
                              torch.stack([c for _, c in parts]))
    s = torch.einsum("bshk,btk->bhst", qa, ckv) * scale
    want = torch.einsum("bhst,btk->bshk", torch.softmax(s, -1), ckv)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-5, "large scores")


def test_a_model_axis_that_does_not_divide_the_experts_raises():
    """Arctic's 56 query heads divide over 7 model ranks, its 128 experts
    do not: the step refuses before any collective, as the reference's
    placements refuse it."""
    from test_torch_tp import _mesh

    b = steps.build_step(ARCTIC, "prefill_32k", _mesh((1, 7)))
    with pytest.raises(NotImplementedError, match="128 experts"):
        b.fn(*[None] * len(b.args))
