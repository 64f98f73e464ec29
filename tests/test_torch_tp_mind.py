"""MIND's serve and retrieval steps with their embedding rows over a
``model`` axis wider than 1, and the GNN train step over such a mesh,
against the one-device step and the JAX package.

The port's ranks are gloo processes on the CPU
(``torch_pg_ranks.tp_mind_gnn_cases``, which imports no JAX), started once
per mesh layout ``(data, model)`` in :data:`LAYOUTS` with every case in
that one start; the reference's bundles run jitted with their shardings
on 4 forced host devices in one subprocess beside them.  Inputs are drawn
from numpy seeds on the ``reduced()`` configs.

MIND: ``item_embed`` and ``profile_embed`` are row pieces over ``model``,
the MLP Megatron-split.  The serve batches hold a profile bag whose slots
lie on both row pieces, a bag of masked slots only and a history of
masked slots only; the retrieval candidates are a permutation of items
on every piece.  Every rank's joined interests are held within 1e-5 of
the one-device step and within the serving tests' tolerance (rtol 1e-4,
atol 1e-5, ``tests/test_torch_mind.py``) of the reference; the retrieval
indices equal the one-device step's.  An id past the whole table still
raises on every rank.

GNN: edges over every axis, parameters replicated; one AdamW step's
loss, parameters and moments within 1e-5 x max(1, max|want|) of the
one-device step's and of the reference's (``tests/test_torch_gnn_train.py``'s
limits).
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
from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models.params import tree_init, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

from test_torch_gnn import cell_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
LAYOUTS = ((1, 2), (2, 2))
ONE_DEVICE_TOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-5)
MIND_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
#: an id one past the whole table, in the profile or in the history
PAST_TABLE = ("profile", "history")
GNN_CASES = {"gcn": ("gcn-cora", "full_graph_sm", 1e-3),
             "sage": ("graphsage-reddit", "minibatch_lg", 1e-3),
             "schnet": ("schnet", "molecule", 1e-3),
             "egnn": ("egnn", "ogb_products", 1e-3)}


def _layout_name(layout) -> str:
    return "x".join(map(str, layout))


def _key(name: str) -> str:
    return "".join(f"[{part!r}]" for part in name.split("."))


def _nest(flat: dict) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


def mind_params(cfg, seed: int = 3) -> dict:
    """MIND's parameters drawn with numpy, the biases too (the specs'
    zeros would hide a bias added on every rank)."""
    rng = np.random.default_rng(seed)
    return _nest({name: torch.as_tensor(rng.normal(
        scale=0.1, size=spec.shape).astype(np.float32))
        for name, spec in tree_leaves(recsys.mind_param_specs(cfg))})


def mind_batch(cfg, cell: str, seed: int) -> dict:
    """A reduced cell's batch: seeded ids with a quarter of the profile
    slots masked; user 0's first bag on both halves of the profile rows,
    user 1's second bag all masked, user 2's history all masked; the
    retrieval candidates a permutation of items."""
    _, av = steps.build_step("mind", cell, reduced=True).args
    rng = np.random.default_rng(seed)
    B, H = av["hist_ids"][0]
    out = {"hist_ids": rng.integers(-1, cfg.n_items, (B, H)),
           "profile_ids": rng.integers(0, cfg.profile_vocab,
                                       av["profile_ids"][0])}
    prof = out["profile_ids"]
    prof[rng.random(prof.shape) < 0.25] = -1
    half = cfg.profile_vocab // 2
    prof[0, 0] = [3, half + 7, -1, cfg.profile_vocab - 1][:prof.shape[-1]]
    prof[1, 1] = -1
    out["hist_ids"][2] = -1
    if "candidate_ids" in av:
        out["candidate_ids"] = rng.permutation(cfg.n_items)[
            :av["candidate_ids"][0][0]]
    return {k: torch.as_tensor(v.astype(np.int32)) for k, v in out.items()}


def _cases() -> dict:
    cases = {f"mind|{c}": {"arch": "mind", "shape": c} for c in MIND_CELLS}
    cases.update({f"mind|past|{w}": {"arch": "mind", "shape": "serve_p99",
                                     "raises": w} for w in PAST_TABLE})
    cases.update({f"gnn|{n}": {"arch": a, "shape": s, "lr": lr}
                  for n, (a, s, lr) in GNN_CASES.items()})
    return cases


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) >= 4
from repro.launch.mesh import use_mesh
from repro.launch.steps import build_step
from repro.optim import AdamWConfig, adamw_init

case_dir, out = sys.argv[1], sys.argv[2]
cases = json.load(open(f"{case_dir}/cases.json"))
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

def flat(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

with np.load(f"{case_dir}/mind.npz") as z:
    mind = nest({k: z[k] for k in z.files})
for lname, (D, M) in layouts.items():
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    res = {}
    for name, case in cases.items():
        if "raises" in case:
            continue
        key = name.replace("|", "__")
        with np.load(f"{case_dir}/{key}.npz") as z:
            params = nest({k[2:]: z[k] for k in z.files if k[:2] == "p."})
            batch = {k[2:]: jnp.asarray(z[k]) for k in z.files
                     if k[:2] == "b."}
        if case["arch"] == "mind":
            b = build_step("mind", case["shape"], mesh, reduced=True)
            fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                         out_shardings=b.out_shardings)
            with use_mesh(mesh):
                got = fn(mind, batch)
            if isinstance(got, tuple):
                res[f"{key}__vals"] = np.asarray(got[0])
                res[f"{key}__idx"] = np.asarray(got[1])
            else:
                res[f"{key}__out"] = np.asarray(got)
            continue
        b = build_step(case["arch"], case["shape"], mesh, reduced=True,
                       opt=AdamWConfig(lr=case["lr"]))
        state = adamw_init(params, b.static["opt"])
        fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        with use_mesh(mesh):
            p2, s2, loss = fn(params, state, batch)
        res[f"{key}__loss"] = np.asarray(loss)
        res.update(flat(p2, f"{key}__p"))
        res.update(flat(s2["mu"], f"{key}__mu"))
    np.savez(f"{out}/{lname}.npz", **res)
print("REFERENCE_OK")
"""


def _one_device(case, x, mind):
    if case["arch"] == "mind":
        b = steps.build_step("mind", case["shape"], reduced=True)
        if "raises" in case:
            with pytest.raises(IndexError):
                b.fn(mind, x)
            return None
        return b.fn(mind, x)
    b = steps.build_step(case["arch"], case["shape"], reduced=True,
                         opt=AdamWConfig(lr=case["lr"]))
    params, state, loss = b.fn(*_step_args(*x))
    return {"params": dict(tree_leaves(params)), "loss": float(loss),
            "mu": dict(tree_leaves(state["mu"]))}


def _step_args(params, opt, batch) -> tuple:
    """A train step's arguments: a copy of ``params`` as nested dicts,
    fresh AdamW state and the batch."""
    params = _nest({n: t.detach().clone() for n, t in tree_leaves(params)})
    return params, adamw_init(params, opt), batch


@pytest.fixture(scope="module")
def tp_mind_runs(tmp_path_factory):
    """The one-device steps, the ranks' runs (one start a layout) and the
    reference's sharded bundles (one subprocess on 4 forced host devices,
    run beside the ranks)."""
    case_dir = tmp_path_factory.mktemp("tp_mind_cases")
    ref_dir = tmp_path_factory.mktemp("tp_mind_reference")
    cfg = get_config("mind").reduced()
    mind = mind_params(cfg)
    torch.save(mind, case_dir / "mind.pt")
    np.savez(case_dir / "mind.npz",
             **{n: t.numpy() for n, t in tree_leaves(mind)})
    cases = _cases()
    one, inputs = {}, {}
    for seed, (name, case) in enumerate(cases.items()):
        key = name.replace("|", "__")
        if case["arch"] == "mind":
            x = mind_batch(cfg, case["shape"], seed)
            w = case.get("raises")
            if w == "profile":
                x["profile_ids"][[0, -1], 0, 0] = cfg.profile_vocab
            elif w == "history":
                x["hist_ids"][[0, -1], 0] = cfg.n_items
            torch.save(x, case_dir / f"{name}.pt")
            np.savez(case_dir / f"{key}.npz",
                     **{f"b.{k}": v.numpy() for k, v in x.items()})
        else:
            gcfg = get_config(case["arch"]).reduced()
            b = steps.build_step(case["arch"], case["shape"], reduced=True,
                                 opt=AdamWConfig(lr=case["lr"]))
            params = tree_init(b.static["pspecs"],
                               torch.Generator().manual_seed(5 + seed))
            batch, _ = cell_inputs(gcfg, case["shape"], seed=seed)
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            x = (params, b.static["opt"], batch)
            torch.save(_step_args(*x), case_dir / f"{name}.pt")
            np.savez(case_dir / f"{key}.npz",
                     **{f"p.{n}": t.detach().numpy()
                        for n, t in tree_leaves(params)},
                     **{f"b.{k}": v.numpy() for k, v in batch.items()})
        inputs[name] = x
        one[name] = _one_device(case, x, mind)
    (case_dir / "cases.json").write_text(json.dumps(cases))
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
            out = tmp_path_factory.mktemp(f"tp_mind_ranks_{lname}")
            run_ranks("torch_pg_ranks:tp_mind_gnn_cases",
                      layout[0] * layout[1], backend="gloo",
                      args=[case_dir, out, *layout], paths=[TESTS],
                      timeout=600, env={"OMP_NUM_THREADS": "1"})
            outs[lname] = out
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
    return {"one": one, "inputs": inputs, "mind": mind, "outs": outs,
            "ref": ref_dir, "cfg": cfg}


def _records(runs, layout, name) -> list:
    out = runs["outs"][_layout_name(layout)]
    return [torch.load(out / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _reference(runs, layout) -> dict:
    with np.load(runs["ref"] / f"{_layout_name(layout)}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("cell", MIND_CELLS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_mind_rows_over_model_equal_one_device_and_the_reference(
        tp_mind_runs, layout, cell):
    """Every rank's joined output: interests (serve) or the top k's values
    within 1e-5 of the one-device step and within the serving tolerance of
    the reference's sharded bundle; the top k's indices equal both."""
    name = f"mind|{cell}"
    key = name.replace("|", "__")
    want = tp_mind_runs["one"][name]
    ref = _reference(tp_mind_runs, layout)
    for r, rec in enumerate(_records(tp_mind_runs, layout, name)):
        what = f"{_layout_name(layout)} {cell} rank {r}"
        if cell == "retrieval_cand":
            vals, idx = rec["out"]
            _close(vals, want[0], ONE_DEVICE_TOL, what)
            assert torch.equal(idx, want[1]), what
            np.testing.assert_allclose(vals.numpy(), ref[f"{key}__vals"],
                                       **TOL, err_msg=what)
            assert np.array_equal(idx.numpy(), ref[f"{key}__idx"]), what
            continue
        assert rec["out"].shape == want.shape
        _close(rec["out"], want, ONE_DEVICE_TOL, what)
        np.testing.assert_allclose(rec["out"].numpy(), ref[f"{key}__out"],
                                   **TOL, err_msg=what)


@pytest.mark.parametrize("cell", ("serve_p99", "serve_bulk"))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_mind_profile_bags_take_the_global_mean(tp_mind_runs, layout, cell):
    """Each rank's bags of the whole batch on its row piece, summed over
    ``model``: the one-device mean bags within 1e-5, user 0's first bag
    (slots on both pieces) among them, and the all-masked bag exactly 0."""
    name = f"mind|{cell}"
    cfg, table = tp_mind_runs["cfg"], tp_mind_runs["mind"]["profile_embed"]
    ids = tp_mind_runs["inputs"][name]["profile_ids"]
    flat = ids.reshape(-1, ids.shape[-1])
    rows = cfg.profile_vocab // layout[1]
    spans = {int(i) // rows for i in flat[0] if i >= 0}
    assert len(spans) > 1  # the bag's slots lie on more than one piece
    want = ebk.embedding_bag(table, flat, mode="mean")
    masked = cfg.n_profile_fields + 1  # user 1's second bag
    assert bool((flat[masked] < 0).all())
    for r, rec in enumerate(_records(tp_mind_runs, layout, name)):
        _close(rec["bags"], want, ONE_DEVICE_TOL,
               f"{_layout_name(layout)} {cell} rank {r} bags")
        assert bool((rec["bags"][masked] == 0).all())


@pytest.mark.parametrize("where", PAST_TABLE)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_mind_id_past_the_whole_table_still_raises(tp_mind_runs, layout,
                                                   where):
    """An id equal to the whole table's rows (past every rank's piece)
    raises IndexError on every rank, as on one device (checked when the
    fixture ran it); it is not taken for a slot another rank holds."""
    name = f"mind|past|{where}"
    for r, rec in enumerate(_records(tp_mind_runs, layout, name)):
        assert "out" not in rec and "rows" in rec["raised"], (r, rec)
        if where == "profile":
            assert "rows" in rec["bags_raised"], r
        else:
            assert "bags" in rec, r


@pytest.mark.parametrize("case", list(GNN_CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_gnn_train_step_over_model(tp_mind_runs, layout, case):
    """One AdamW step with the edges over every axis of a mesh whose
    model axis is 2: loss, parameters and moments within 1e-5 x max(1,
    max|want|) of the one-device step's and of the reference's."""
    name = f"gnn|{case}"
    key = name.replace("|", "__")
    want = tp_mind_runs["one"][name]
    before = dict(tree_leaves(tp_mind_runs["inputs"][name][0]))
    ref = _reference(tp_mind_runs, layout)

    def hold(got, w, what):
        w = torch.as_tensor(w).detach().float()
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        _close(got, w, tol, what)

    for r, rec in enumerate(_records(tp_mind_runs, layout, name)):
        what = f"{_layout_name(layout)} {case} rank {r}"
        loss = float(rec["loss"])
        assert abs(loss - want["loss"]) <= 1e-5 * max(1, abs(want["loss"]))
        rl = float(ref[f"{key}__loss"])
        assert abs(loss - rl) <= 1e-5 * max(1, abs(rl)), what
        params = dict(tree_leaves(rec["params"]))
        assert set(params) == set(want["params"])
        moved = 0
        for n, t in params.items():
            hold(t.detach(), want["params"][n], f"{what} {n}")
            hold(t.detach(), ref[f"{key}__p{_key(n)}"], f"{what} {n} ref")
            moved += int(not torch.equal(t, before[n]))
        assert moved, what
        mu = dict(tree_leaves(rec["state"]["mu"]))
        assert set(mu) == set(want["mu"])
        for n, t in mu.items():
            hold(t, want["mu"][n], f"{what} mu.{n}")
            hold(t, ref[f"{key}__mu{_key(n)}"], f"{what} mu.{n} ref")
