"""MoE over more than one data rank at the reference's global capacity,
serving and training, against the one-device step and the JAX package.

The reference counts a MoE layer's capacity ``C = max(8, int(T k / X
cf))`` over the whole batch and keeps the first C assignments of each
expert in global token order (``src/repro/models/moe.py``).  A port rank
that holds a slice of the batch's rows all-gathers the per-expert counts
over the batch axes, offsets its positions by the ranks before it and
takes C of the global token count (``models.moe``, ``layers.BatchSplit``).

The port's ranks are gloo processes on the CPU
(``torch_pg_ranks.moe_data_cases``, which imports no JAX), started once
per mesh layout ``(data, model)`` in :data:`LAYOUTS` with every case in
that one start: DeepSeek-V3's and Arctic's ``reduced()`` configs in
float32, ``prefill_32k`` (Arctic's also with a skewed router whose drops
on data rank 1 depend on rank 0's tokens), three ``decode_32k`` steps
from a seeded cache, ``long_500k`` (batch 1, whole on every rank) at
(2, 2), and two ``train_4k`` steps, one case with four rows in two
microbatches (``REPRO_TORCH_ACCUM_TOKENS`` and the reference's
``REPRO_ACCUM_TOKENS`` 64 on the mesh; 128 on one device, so that it
takes the same two microbatches).  Each is held within 1e-5 of the
one-device step (serving's logits and cache pieces; training's loss,
parameters and moments) and within 2e-4 (serving) or 1e-4 (training) of
the reference's bundle jitted with its shardings on 4 forced host devices
(a subprocess a layout, beside the ranks).  Every rank routes its tokens
as one device routes them; every leaf that the mesh does not split is
equal bit for bit on every rank after a step.
"""
import contextlib
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
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from test_torch_tp import DECODE_STEPS, long_lengths, start_lengths  # noqa: E402
from test_torch_tp_moe import (ARCTIC, DSV3, SKEWED, _inputs,  # noqa: E402
                               _one_device as serve_one_device, _params)
from test_torch_tp_moe_train import (lm_batches, one_device,  # noqa: E402
                                     opt_kw, reference_env, reference_flat,
                                     save_case, skew)
from test_torch_tp_train import _flat, _hold, draw_params  # noqa: E402
from torch_pg_ranks import moment_faults, train_bundle  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
LAYOUTS = ((2, 1), (2, 2))
ONE_DEVICE_TOL = 1e-5
SERVE_REFERENCE_TOL, TRAIN_REFERENCE_TOL = 2e-4, 1e-4
#: the microbatch token budget on the mesh (two data ranks, so 4 rows of
#: 64 make two microbatches of 2 rows) and on one device (the same two)
MESH_ACCUM_TOKENS, ONE_ACCUM_TOKENS = 64, 128
#: name -> (arch, rows of the batch or None for the cell's, router skewed)
TRAIN_CASES = {"deepseek-v3": (DSV3, None, False),
               "arctic": (ARCTIC, None, False),
               "arctic|accum": (ARCTIC, 4, True)}


def _layout_name(layout) -> str:
    return "x".join(map(str, layout))


def _T(shape: str) -> int:
    return steps.build_step(DSV3, shape, reduced=True).args[2]["ckv"][0][2]


def serve_cases(layout) -> dict:
    """The serving cases of a layout: prefill of both archs and Arctic's
    skewed prefill; decode from one below the first piece boundary of the
    sequence over ``model`` (inside the cache where M = 1); at (2, 2)
    long_500k from one below its first piece boundary."""
    D, M = layout
    cases = {}
    for arch in (DSV3, ARCTIC):
        cases[f"{arch}|prefill"] = {"arch": arch, "shape": "prefill_32k",
                                    "params": arch}
        tag = "boundary" if M > 1 else "inside"
        cases[f"{arch}|decode"] = {
            "arch": arch, "params": arch, "shape": "decode_32k",
            "len": start_lengths(_T("decode_32k"), M)[tag]}
        if M > 1:
            cases[f"{arch}|long"] = {
                "arch": arch, "params": arch, "shape": "long_500k",
                "len": long_lengths(_T("long_500k"), D * M)["boundary1"]}
    cases[f"{ARCTIC}|prefill|skewed"] = {"arch": ARCTIC, "params": SKEWED,
                                         "shape": "prefill_32k"}
    return cases


def train_case(name: str) -> dict:
    arch, rows, _ = TRAIN_CASES[name]
    case = {"arch": arch, "shape": "train_4k", "opt": opt_kw(False),
            "ckpt": False}
    if rows:
        case["rows"] = rows
    return case


@contextlib.contextmanager
def accum_tokens(n: int):
    """``REPRO_TORCH_ACCUM_TOKENS`` set to ``n`` while a step is built."""
    old = os.environ.get("REPRO_TORCH_ACCUM_TOKENS")
    os.environ["REPRO_TORCH_ACCUM_TOKENS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_TORCH_ACCUM_TOKENS"]
        else:
            os.environ["REPRO_TORCH_ACCUM_TOKENS"] = old


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) >= 4
from repro.configs import get_config
from repro.launch.mesh import use_mesh
from repro.launch.steps import _build_lm, build_step
from repro.optim import AdamWConfig

case_dir, out, lname = sys.argv[1:4]
D, M = json.load(open(f"{case_dir}/layouts.json"))[lname]
mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))

def nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return tree

def flat(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

res, params, fns = {}, {}, {}
for name, case in json.load(open(f"{case_dir}/{lname}/cases.json")).items():
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
for name, case in json.load(open(f"{case_dir}/train_cases.json")).items():
    key = name.replace("|", "__")
    with np.load(f"{case_dir}/train_{key}.npz") as z:
        def part(prefix):
            return {k[len(prefix):]: z[k] for k in z.files
                    if k.startswith(prefix)}
        states = [(nest(part(f"p{i}.")),
                   {"step": jnp.int32(int(z[f"step{i}"])),
                    "mu": nest(part(f"mu{i}."))}) for i in range(2)]
        batches = [{k: jnp.asarray(v) for k, v in part(f"b{i}.").items()}
                   for i in range(2)]
    opt = AdamWConfig(**case["opt"])
    if "rows" in case:
        cfg = get_config(case["arch"]).reduced()
        S = batches[0]["tokens"].shape[1]
        av = jax.ShapeDtypeStruct((case["rows"], S), jnp.int32)
        b = _build_lm(cfg, case["shape"], "train", {"tokens": av,
                      "labels": av}, mesh, opt, True)
    else:
        b = build_step(case["arch"], case["shape"], mesh, reduced=True,
                       opt=opt)
    res[f"{key}__accum"] = np.asarray(b.static["accum"])
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    with use_mesh(mesh):
        for i, (batch, (p, state)) in enumerate(zip(batches, states)):
            p, state, loss = fn(p, state, batch["tokens"], batch["labels"])
            res[f"{key}__{i}__loss"] = np.asarray(loss)
            res.update(flat(p, f"{key}__{i}__p"))
            res.update(flat(state["mu"], f"{key}__{i}__mu"))
np.savez(f"{out}/{lname}.npz", **res)
print("REFERENCE_MOE_DATA_OK")
"""


def _save_serve(case_dir, lname, name, case, x) -> None:
    torch.save(x, case_dir / lname / f"{name}.pt")
    key = name.replace("|", "__")
    if case["shape"] == "prefill_32k":
        np.savez(case_dir / lname / f"{key}.npz", tokens=x["tokens"].numpy())
        return
    np.savez(case_dir / lname / f"{key}.npz", len=case["len"],
             steps=DECODE_STEPS,
             **{f"cache_{k}": v.numpy() for k, v in x["caches"].items()
                if k != "len"},
             **{f"tok{i}": t.numpy() for i, t in enumerate(x["tokens"])})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device steps, the ranks' runs (one start a layout) and the
    reference's sharded bundles (a subprocess a layout, beside them)."""
    case_dir = tmp_path_factory.mktemp("moe_data_cases")
    ref_dir = tmp_path_factory.mktemp("moe_data_reference")
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
        cases = serve_cases(layout)
        (case_dir / lname / "cases.json").write_text(json.dumps(cases))
        for seed, (name, case) in enumerate(cases.items()):
            x = _inputs(case, 100 + seed)
            _save_serve(case_dir, lname, name, case, x)
            one[lname, name] = serve_one_device(params[case["params"]],
                                                case, x)
    train = {}
    for seed, name in enumerate(TRAIN_CASES):
        arch, rows, skewed = TRAIN_CASES[name]
        case = train_case(name)
        with accum_tokens(ONE_ACCUM_TOKENS):
            b = train_bundle(case)
        p = draw_params(b.static["pspecs"], 120 + seed)
        if skewed:
            skew(p)
        batches = lm_batches(arch, rows or 2, 140 + seed)
        before, after, routes = one_device(b, p, batches)
        train[name] = {"after": after, "routes": routes, "inputs": p,
                       "accum": b.static["accum"], "batches": batches}
        save_case(case_dir / f"train_{name}.pt",
                  case_dir / f"train_{name.replace('|', '__')}.npz", before,
                  batches)
    (case_dir / "train_cases.json").write_text(json.dumps(
        {n: train_case(n) for n in TRAIN_CASES}))
    (case_dir / "layouts.json").write_text(json.dumps(
        {_layout_name(lo): lo for lo in LAYOUTS}))
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, case_dir, ref_dir,
         _layout_name(layout)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=reference_env(REPRO_ACCUM_TOKENS=str(MESH_ACCUM_TOKENS)))
        for layout in LAYOUTS]
    outs = {}
    try:
        for layout in LAYOUTS:
            lname = _layout_name(layout)
            out = tmp_path_factory.mktemp(f"moe_data_ranks_{lname}")
            (case_dir / lname / "train_cases.json").write_text(
                (case_dir / "train_cases.json").read_text())
            for name in TRAIN_CASES:
                (case_dir / lname / f"train_{name}.pt").write_bytes(
                    (case_dir / f"train_{name}.pt").read_bytes())
            run_ranks("torch_pg_ranks:moe_data_cases",
                      layout[0] * layout[1], backend="gloo",
                      args=[case_dir / lname, case_dir, out, *layout],
                      paths=[TESTS], timeout=600,
                      env={"OMP_NUM_THREADS": "1",
                           "REPRO_TORCH_ACCUM_TOKENS":
                               str(MESH_ACCUM_TOKENS)})
            outs[lname] = out
        for ref in refs:
            stdout, stderr = ref.communicate(timeout=600)
            assert ref.returncode == 0 and \
                "REFERENCE_MOE_DATA_OK" in stdout, stderr[-3000:]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    return {"one": one, "train": train, "outs": outs, "ref": ref_dir}


def _records(runs, layout, name) -> list:
    out = runs["outs"][_layout_name(layout)]
    return [torch.load(out / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _data_rows(t, layout, rec, per_rank: int):
    """Rows ``[d * per_rank, (d + 1) * per_rank)`` of ``t``, ``d`` the
    record's data coordinate."""
    d = rec["coords"]["data"]
    return t[d * per_rank:(d + 1) * per_rank]


def _hold_serve(runs, layout, name) -> list:
    """Every rank's joined logits against the one-device step and the
    reference; its routes the one device's routes of its own tokens (all
    of them for long_500k's row, whole on every rank); its cache pieces
    the one device's final caches cut by the placements."""
    lname = _layout_name(layout)
    one = runs["one"][lname, name]
    key = name.replace("|", "__")
    recs = _records(runs, layout, name)
    D, M = layout
    long_ctx = "|long" in name
    with np.load(runs["ref"] / f"{lname}.npz") as z:
        ref = [torch.as_tensor(z[f"{key}__{i}"])
               for i in range(len(one["logits"]))]
    for r, rec in enumerate(recs):
        what = f"{lname} {name} rank {r}"
        assert len(rec["logits"]) == len(one["logits"]), what
        for i, (got, want) in enumerate(zip(rec["logits"], one["logits"])):
            assert got.shape == want.shape, what
            _close(got, want, ONE_DEVICE_TOL, f"{what} step {i}")
            _close(got, ref[i], SERVE_REFERENCE_TOL,
                   f"{what} step {i} vs the reference")
        assert len(rec["routes"]) == len(one["routes"]) > 0, what
        for got, want in zip(rec["routes"], one["routes"]):
            if not long_ctx:
                want = _data_rows(want, layout, rec, want.shape[0] // D)
            assert torch.equal(got, want), what
        if "caches" not in one:
            continue
        for k, want in one["caches"].items():
            if k == "len":
                assert int(rec["caches"]["len"]) == int(want), what
                continue
            T = want.shape[2]
            if long_ctx:
                P, p = D * M, rec["coords"]["data"] * M + \
                    rec["coords"]["model"]
            else:
                P, p = M, rec["coords"]["model"]
                want = _data_rows(want.transpose(0, 1), layout, rec,
                                  want.shape[1] // D).transpose(0, 1)
            _close(rec["caches"][k], want[:, :, p * (T // P):(p + 1) * (
                T // P)], ONE_DEVICE_TOL, f"{what} cache {k}")
    return recs


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", (DSV3, ARCTIC))
def test_prefill_over_data_ranks_equals_one_device_and_the_reference(
        runs, arch, layout):
    """``prefill_32k`` with the batch's rows over the data ranks (and the
    experts over ``model`` at (2, 2)): the joined logits and each rank's
    routes; every MoE call counted its capacity over the batch axes."""
    name = f"{arch}|prefill"
    for rec in _hold_serve(runs, layout, name):
        assert rec["splits"] == [(layout[0], rec["coords"]["data"], True)] \
            * len(rec["routes"]), rec["splits"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", (DSV3, ARCTIC))
def test_decode_over_data_ranks_equals_one_device_and_the_reference(
        runs, arch, layout):
    """Three ``decode_32k`` steps, the cache's rows over the data ranks
    and its sequence over ``model``: every step's joined logits, each
    rank's routes and its cache pieces after them."""
    name = f"{arch}|decode"
    for rec in _hold_serve(runs, layout, name):
        assert set(rec["splits"]) == {(layout[0], rec["coords"]["data"],
                                       True)}


@pytest.mark.parametrize("arch", (DSV3, ARCTIC))
def test_long_500k_over_data_ranks_keeps_its_own_capacity(runs, arch):
    """``long_500k`` at (2, 2): its one row whole on every rank, the cache
    sequence over all four ranks, the experts' embed pieces joined over
    the data axis for the products.  Held as the decode cases, every step
    written on exactly one rank, and every MoE call given the batch axes
    without rows: its capacity is the rank's own.  Fails with the counts
    summed over the data ranks (each rank's one token counted D times; at
    these sizes that leaves the logits alone, as no position reaches the
    capacity of 8, but past 8 data ranks it drops the token's experts)."""
    layout = (2, 2)
    name = f"{arch}|long"
    recs = _hold_serve(runs, layout, name)
    for rec in recs:
        assert set(rec["splits"]) == {(2, rec["coords"]["data"], False)}
    for i in range(DECODE_STEPS):
        assert sum(rec["written"][i] for rec in recs) == 1, (name, i)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_skewed_prefill_drops_by_the_global_count(runs, layout):
    """Arctic's prefill with a skewed router: data rank 1 drops
    assignments that it would keep counting its own tokens alone, because
    rank 0's tokens of the same experts come first in the global order;
    the ranks keep the one device's choice (their logits and routes), and
    the assignments that the ranks drop (``moe_apply``'s
    ``aux["dropped"]``, summed over the data ranks; each model rank of a
    data rank counts alike) are the one device's, a MoE call at a time.
    Fails with a rank's own capacity and no prefix."""
    name = f"{ARCTIC}|prefill|skewed"
    recs = _hold_serve(runs, layout, name)
    want = runs["one"][_layout_name(layout), name]["dropped"]
    assert len(want) > 0 and min(want) > 0, want
    for rec in recs:
        peer = next(r for r in recs if r["coords"]["data"] ==
                    rec["coords"]["data"] and r["coords"]["model"] == 0)
        assert rec["dropped"] == peer["dropped"], rec["coords"]
    firsts = [r for r in recs if r["coords"]["model"] == 0]
    assert len(firsts) == layout[0]
    assert [sum(d) for d in zip(*(r["dropped"] for r in firsts))] == want
    cfg = get_config(ARCTIC).reduced()
    X = cfg.moe.num_experts
    for e in runs["one"][_layout_name(layout), name]["routes"]:
        T = e.shape[0]
        C = moe_capacity(cfg.moe, T)
        n0, n1 = (torch.bincount(part.reshape(-1), minlength=X)
                  for part in (e[:T // 2], e[T // 2:]))
        # rank 1's assignments with a position under C among its own
        # tokens and at or past C in the global order
        late = (n1.clamp(max=C) - (C - n0).clamp(min=0)).clamp(min=0)
        assert int(late.sum()) > 0, (n0, n1, C)


def test_experts_embed_pieces_are_joined_a_group_at_a_time(runs):
    """At (2, 2) serving gathers no weight piece but the experts' embed
    pieces (``expert_embed`` over the data axis), of the experts that
    some data rank's tokens reach: a prefill, whose tokens reach every
    expert, joins their three matrices, one all-gather each a MoE layer
    (the reduced experts make one group; a decode step's two tokens reach
    at most four of Arctic's eight experts, and it joins theirs alone,
    held by the decode cases' logits)."""
    for name in serve_cases((2, 2)):
        for rec in _records(runs, (2, 2), name):
            names = rec["gathered_weights"]
            assert set(names) <= {"layers.moe.w_gate", "layers.moe.w_up",
                                  "layers.moe.w_down"}, name
            if "prefill" in name:
                assert len(names) == 3 * len(rec["routes"]), name


# ----------------------------------------------------------- training
@pytest.mark.parametrize("name", list(TRAIN_CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_train_over_data_ranks_equals_one_device_and_the_reference(
        runs, layout, name):
    """Two steps with the batch's rows over the data ranks (the experts
    over ``model`` at (2, 2)): the joined loss, parameters and moments on
    every rank within 1e-5 of the one-device step and within 1e-4 of the
    reference's.  The four-row case takes two microbatches on one device,
    on the mesh and in the reference; it fails with a rank's microbatch
    cut from its own rows (a MoE layer's drops then come from other
    tokens)."""
    lname = _layout_name(layout)
    one = runs["train"][name]
    key = name.replace("|", "__")
    with np.load(runs["ref"] / f"{lname}.npz") as z:
        assert int(z[f"{key}__accum"]) == one["accum"]
        ref = [reference_flat(z, key, i, one["after"][i]) for i in range(2)]
    mesh = Mesh(layout, ("data", "model"))
    with accum_tokens(MESH_ACCUM_TOKENS):
        assert train_bundle(train_case(name), mesh).static["accum"] == \
            one["accum"] == (2 if TRAIN_CASES[name][1] else 1)
    for r, rec in enumerate(_records(runs, layout, name)):
        for i, (params, state, loss) in enumerate(rec["whole"]):
            got = _flat(params, state, loss)
            what = f"{lname} {name} rank {r} step {i + 1}"
            _hold(got, one["after"][i], ONE_DEVICE_TOL, what)
            _hold(got, ref[i], TRAIN_REFERENCE_TOL, what + " vs the reference")


@pytest.mark.parametrize("name", list(TRAIN_CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_train_over_data_ranks_joins_no_moment(runs, layout, name):
    """In each step every rank formed no moment tensor past its ZeRO-1
    share (its float32 moments' piece) and all-gathered no moment
    (``torch_pg_ranks._MomentSpy``)."""
    for r, rec in enumerate(_records(runs, layout, name)):
        assert not moment_faults(rec), (_layout_name(layout), name, r,
                                        moment_faults(rec))


@pytest.mark.parametrize("name", list(TRAIN_CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_train_routes_and_whole_leaves_over_data_ranks(runs, layout, name):
    """Each rank routes its slice of every microbatch as one device does
    (each MoE call, the forward and its recompute), every call counted its
    capacity over the batch axes, and after each step every leaf that the
    mesh does not split is equal bit for bit on every rank."""
    D = layout[0]
    one = runs["train"][name]
    recs = _records(runs, layout, name)
    b = train_bundle(train_case(name), Mesh(layout, ("data", "model")))
    whole = [n for n, sh in tree_leaves(b.in_shardings[0]) if sh.frac == 1]
    assert "layers.moe.router" in whole
    for r, rec in enumerate(recs):
        for i in range(2):
            want = one["routes"][i]
            assert len(rec["routes"][i]) == len(want) > 0, (name, r, i)
            for got, w in zip(rec["routes"][i], want):
                assert torch.equal(got, _data_rows(w, layout, rec,
                                                   w.shape[0] // D))
            assert set(rec["splits"][i]) == {(D, rec["coords"]["data"],
                                             True)}
    for i in range(2):
        first = dict(tree_leaves(recs[0]["pieces"][i][0]))
        for rec in recs[1:]:
            got = dict(tree_leaves(rec["pieces"][i][0]))
            for n in whole:
                assert torch.equal(got[n], first[n]), (name, i + 1, n)


def _kept(routes, C: int, X: int):
    """Which of ``routes``' (T, k) assignments the reference keeps: the
    first ``C`` of each expert in token order."""
    flat = routes.reshape(-1)
    order = torch.argsort(flat, stable=True)
    pos = torch.empty_like(order)
    start = torch.searchsorted(flat[order], torch.arange(X))
    pos[order] = torch.arange(flat.numel()) - start[flat[order]]
    return (pos < C).reshape(routes.shape)


def test_microbatches_are_slices_of_the_global_ones(runs):
    """The four-row case's precondition: its MoE layers drop, and which
    assignments they keep depends on the microbatches' rows.  Rows {0, 1}
    and {2, 3} (the reference's, the global batch cut over the ranks)
    keep other assignments than {0, 2} and {1, 3} (each rank's own rows
    cut into microbatches), so the hold above tells the two apart."""
    cfg = get_config(ARCTIC).reduced()
    X = cfg.moe.num_experts
    one = runs["train"]["arctic|accum"]
    S = one["batches"][0][0].shape[1]
    forward = one["routes"][0]                  # microbatch 0, then 1
    n_moe = len(forward) // 4                   # forward and recompute
    rows = {}
    for mb in range(2):
        for layer in range(n_moe):
            e = forward[mb * 2 * n_moe + layer]
            for j in range(2):
                rows[2 * mb + j, layer] = e[j * S:(j + 1) * S]
    # the first MoE layer: its routes are each row's own, whatever rows
    # share its microbatch
    C = moe_capacity(cfg.moe, 2 * S)
    ref, differ = {}, 0
    for group in ((0, 1), (2, 3)):
        kept = _kept(torch.cat([rows[g, 0] for g in group]), C, X)
        assert not bool(kept.all())
        ref.update({g: kept[i * S:(i + 1) * S] for i, g in enumerate(group)})
    for group in ((0, 2), (1, 3)):
        kept = _kept(torch.cat([rows[g, 0] for g in group]), C, X)
        differ += sum(int((kept[i * S:(i + 1) * S] != ref[g]).sum())
                      for i, g in enumerate(group))
    assert differ > 0
