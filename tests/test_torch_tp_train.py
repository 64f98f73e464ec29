"""Training over a ``model`` axis wider than 1: the dense LMs' train step
under Megatron tensor parallelism (autograd-aware collectives, the
vocab-parallel loss, moments kept as model pieces), MIND's train step
with its rows over ``model``, and checkpoint restore onto placements,
against the one-device step and the JAX package.

The port's ranks are gloo processes on the CPU
(``torch_pg_ranks.tp_train_cases``, which imports no JAX), started once
per mesh layout ``(data, model)`` in :data:`LAYOUTS` with every case in
that one start; the reference's bundles run jitted with their shardings
on 4 forced host devices, a subprocess a layout, beside them.  Each case takes
two steps at lr 1e-3 (AdamW's eps 1e-4, :data:`EPS`), each from the
one-device run's state before it, from parameters drawn with numpy (norm
weights and biases off their ones and zeros), on the ``reduced()``
configs: the
three dense GQA ids' ``train_4k`` (``n_kv = 2``, so (1, 4) gathers k
and v whole) with Yi-34B's moments forced to int8, and MIND's
``train_batch``.  Loss, every parameter and every moment after each step
are held within 1e-5 of the one-device step (moments relative to their
largest, as ``tests/test_torch_launch.py`` holds them) and within 1e-4
of the reference's.

The (1, 2) start saves Qwen3-0.6B's state whole after step 1; the (1, 4)
and (2, 2) starts restore it onto their placements and take step 2, as
one device does here, each held to the uninterrupted one-device run.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
CPU = torch.device("cpu")
LAYOUTS = ((1, 2), (1, 4), (2, 2))
LR = 1e-3
#: AdamW's eps.  An element whose gradient, or whose int8-decoded second
#: moment, is near 0 moves by up to lr x m / eps, and turns the float32
#: error of its gradient (~1e-9 here) into lr x m x error / eps**2; at
#: 1e-4 that stays under 1e-8 of a parameter, so the 1e-5 hold reads the
#: gradients to ~1e-6 (at the default 1e-8 int8 moments moved a parameter
#: by 1e-4 between two runs from one state)
EPS = 1e-4
ONE_DEVICE_TOL = 1e-5
REFERENCE_TOL = 1e-4
#: name -> (arch, cell, int8 moments, checkpointed after step 1)
CASES = {"qwen3-0.6b": ("qwen3-0.6b", "train_4k", False, True),
         "qwen3-14b": ("qwen3-14b", "train_4k", False, False),
         "yi-34b|q8": ("yi-34b", "train_4k", True, False),
         "mind": ("mind", "train_batch", False, False)}
CKPT_CASE = "qwen3-0.6b"
#: the (1, 2) start saves the checkpoint the later starts restore
CKPT_MODE = {(1, 2): "save", (1, 4): "restore", (2, 2): "restore"}
#: the Functions' shapes: x (B, E), W (E, N), C (B, N)
FN_SHAPE = (6, 5, 8)


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


def _opt_kw(name: str) -> dict:
    return {"lr": LR, "eps": EPS, "quantize_moments": CASES[name][2]}


def _opt(name: str) -> AdamWConfig:
    return AdamWConfig(**_opt_kw(name))


def draw_params(pspecs, seed: int) -> dict:
    """Every leaf drawn with numpy: normal leaves N(0, 1) x max(scale,
    0.1), norm weights 1 + N(0, 0.1), biases N(0, 0.1) (the specs' ones
    and zeros would hide a gradient summed on the wrong ranks)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in tree_leaves(pspecs):
        x = rng.normal(size=spec.shape).astype(np.float32)
        if spec.init == "ones":
            x = 1 + 0.1 * x
        elif spec.init == "zeros":
            x = 0.1 * x
        else:
            x = x * max(spec.scale, 0.1)
        out[name] = torch.as_tensor(x).to(spec.dtype)
    return _nest(out)


def _batches(name: str, seed: int) -> list:
    """Two seeded batches of a case, each a tuple of the step's batch
    arguments; MIND's with masked history and profile slots and ids on
    every row piece."""
    arch, cell = CASES[name][:2]
    cfg = get_config(arch).reduced()
    b = steps.build_step(arch, cell, reduced=True)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        if cfg.kind == "lm":
            (B, S), _ = b.args[2]
            tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
            out.append((torch.as_tensor(tok[:, :-1]),
                        torch.as_tensor(tok[:, 1:])))
            continue
        av = b.args[2]
        x = {k: rng.integers(0, cfg.n_items, av[k][0])
             for k in ("hist_ids", "target_id", "negative_ids")}
        x["hist_ids"][rng.random(x["hist_ids"].shape) < 0.25] = -1
        x["hist_ids"][1] = -1
        prof = rng.integers(0, cfg.profile_vocab, av["profile_ids"][0])
        prof[rng.random(prof.shape) < 0.25] = -1
        prof[0, 0] = [3, cfg.profile_vocab // 2 + 7, -1,
                      cfg.profile_vocab - 1][:prof.shape[-1]]
        prof[1, 1] = -1
        x["profile_ids"] = prof
        out.append(({k: torch.as_tensor(v.astype(np.int32))
                     for k, v in x.items()},))
    return out


def _copy(tree):
    return _nest({n: t.detach().clone() for n, t in tree_leaves(tree)})


def _state_copy(state) -> dict:
    return {"step": state["step"].clone(), "mu": _copy(state["mu"])}


def _one_device(name: str, params, batches) -> tuple:
    """The one-device run from fresh AdamW state over ``batches``: the
    whole ``(params, state)`` before each step, and after each step its
    outputs flattened."""
    arch, cell = CASES[name][:2]
    b = steps.build_step(arch, cell, reduced=True, opt=_opt(name))
    params = _copy(params)
    state = adamw_init(params, b.static["opt"])
    before, after = [], []
    for batch in batches:
        before.append((_copy(params), _state_copy(state)))
        params, state, loss = b.fn(params, state, *batch)
        after.append(_flat(params, state, loss))
    return before, after


def _flat(params, state, loss) -> dict:
    """``{"params": {name: leaf}, "mu": {name: leaf}, "step", "loss"}``,
    every leaf detached and copied."""
    return {"params": {n: t.detach().clone() for n, t in tree_leaves(params)},
            "mu": {n: t.detach().clone()
                   for n, t in tree_leaves(state["mu"])},
            "step": int(state["step"]), "loss": float(loss)}


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) >= 4
from repro.launch.mesh import use_mesh
from repro.launch.steps import build_step
from repro.optim import AdamWConfig, adamw_init
from repro.train import checkpoint

case_dir, out, lname = sys.argv[1:4]
cases = json.load(open(f"{case_dir}/ref_cases.json"))
D, M = json.load(open(f"{case_dir}/layouts.json"))[lname]

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

mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
res = {}
for name, (arch, cell, opt, ckpt) in cases.items():
    key = name.replace("|", "__")
    with np.load(f"{case_dir}/{key}.npz") as z:
        def part(prefix):
            return {k[len(prefix):]: z[k] for k in z.files
                    if k.startswith(prefix)}
        states = [(nest(part(f"p{i}.")),
                   {"step": jnp.int32(int(z[f"step{i}"])),
                    "mu": nest(part(f"mu{i}."))}) for i in range(2)]
        batches = [{k: jnp.asarray(v) for k, v in part(f"b{i}.").items()}
                   for i in range(2)]
    opt = AdamWConfig(**opt)
    b = build_step(arch, cell, mesh, reduced=True, opt=opt)
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    with use_mesh(mesh):
        for i, (batch, (params, state)) in enumerate(zip(batches, states)):
            args = ([batch] if arch == "mind"
                    else [batch["tokens"], batch["labels"]])
            params, state, loss = fn(params, state, *args)
            res[f"{key}__{i}__loss"] = np.asarray(loss)
            res.update(flat(params, f"{key}__{i}__p"))
            res.update(flat(state["mu"], f"{key}__{i}__mu"))
            if i == 0 and ckpt and lname == "1x2":
                checkpoint.save(f"{out}/ckpt", 1, (params, state))
np.savez(f"{out}/{lname}.npz", **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device runs, the ranks' runs (one start a layout, in
    :data:`LAYOUTS` order: (1, 2) saves the checkpoint the others
    restore) and the reference's sharded bundles (a subprocess a layout
    on 4 forced host devices, beside the ranks)."""
    case_dir = tmp_path_factory.mktemp("tp_train_cases")
    ref_dir = tmp_path_factory.mktemp("tp_train_reference")
    ckpt_dir = tmp_path_factory.mktemp("tp_train_ckpt")
    one, inputs = {}, {}
    for seed, (name, (arch, cell, q8, ckpt)) in enumerate(CASES.items()):
        b = steps.build_step(arch, cell, reduced=True, opt=_opt(name))
        params = draw_params(b.static["pspecs"], 20 + seed)
        batches = _batches(name, 40 + seed)
        before, one[name] = _one_device(name, params, batches)
        torch.save({"states": before, "batches": batches},
                   case_dir / f"{name}.pt")
        flat = {}
        for i, (batch, (p, st)) in enumerate(zip(batches, before)):
            if isinstance(batch[0], dict):
                flat.update({f"b{i}.{k}": v.numpy()
                             for k, v in batch[0].items()})
            else:
                flat.update({f"b{i}.tokens": batch[0].numpy(),
                             f"b{i}.labels": batch[1].numpy()})
            flat.update({f"p{i}.{n}": t.numpy() for n, t in tree_leaves(p)})
            flat.update({f"mu{i}.{n}": t.numpy()
                         for n, t in tree_leaves(st["mu"])})
            flat[f"step{i}"] = st["step"].numpy()
        np.savez(case_dir / f"{name.replace('|', '__')}.npz", **flat)
        inputs[name] = (params, batches)
    (case_dir / "ref_cases.json").write_text(json.dumps(
        {n: (a, c, _opt_kw(n), k) for n, (a, c, _, k) in CASES.items()}))
    (case_dir / "cases.json").write_text(json.dumps(
        {n: {"arch": a, "shape": c, "opt": _opt_kw(n), "ckpt": k}
         for n, (a, c, _, k) in CASES.items()}))
    (case_dir / "layouts.json").write_text(json.dumps(
        {_layout_name(lo): lo for lo in LAYOUTS}))
    rng = np.random.default_rng(3)
    B, E, N = FN_SHAPE
    fns = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
           for k, s in (("x", (B, E)), ("W", (E, N)), ("C", (B, N)))}
    torch.save(fns, case_dir / "functions.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, case_dir,
                              ref_dir, _layout_name(layout)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=ROOT)
            for layout in LAYOUTS]
    outs = {}
    try:
        def start(layout):
            out = tmp_path_factory.mktemp(
                f"tp_train_ranks_{_layout_name(layout)}")
            run_ranks("torch_pg_ranks:tp_train_cases",
                      layout[0] * layout[1], backend="gloo",
                      args=[case_dir, out, *layout,
                            f"{CKPT_MODE[layout]}:{ckpt_dir}"],
                      paths=[TESTS], timeout=600,
                      env={"OMP_NUM_THREADS": "1"})
            outs[_layout_name(layout)] = out

        # the layouts that restore start together, after the one that saves
        for layout in LAYOUTS:
            if CKPT_MODE[layout] == "save":
                start(layout)
        with ThreadPoolExecutor(2) as pool:
            for done in [pool.submit(start, lo) for lo in LAYOUTS
                         if CKPT_MODE[lo] == "restore"]:
                done.result()
        for ref in refs:
            stdout, stderr = ref.communicate(timeout=600)
            assert ref.returncode == 0 and "REFERENCE_OK" in stdout, \
                stderr[-3000:]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    return {"one": one, "inputs": inputs, "outs": outs, "ref": ref_dir,
            "ckpt": ckpt_dir, "functions": fns}


def _records(runs, layout, name) -> list:
    out = runs["outs"][_layout_name(layout)]
    return [torch.load(out / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


def _hold(got: dict, want: dict, tol: float, what: str) -> None:
    """Loss within ``tol`` x max(1, |loss|), every parameter within
    ``tol`` and every moment within ``tol`` x its largest; int8 moment
    codes within one step (a float32 moment within a rounding error of a
    code's boundary may round either way; their scales are held as the
    float32 moments are, and :func:`test_int8_moments_of_pieces` holds
    the pieces' codes bit for bit on equal gradients)."""
    loss = want["loss"]
    assert abs(got["loss"] - loss) <= tol * max(1, abs(loss)), \
        (what, got["loss"], loss)
    assert set(got["params"]) == set(want["params"]), what
    for k, w in want["params"].items():
        err = float((got["params"][k].float() - w.float()).abs().max())
        assert err <= tol, f"{what} param {k}: {err} > {tol}"
    assert set(got["mu"]) == set(want["mu"]), what
    for k, w in want["mu"].items():
        if w.dtype == torch.int8:
            err = int((got["mu"][k].int() - w.int()).abs().max())
            assert err <= 1, f"{what} int8 moment {k}: codes {err} apart"
            continue
        w = w.float()
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got["mu"][k].float() - w).abs().max())
        assert err <= tol * scale, \
            f"{what} moment {k}: {err} > {tol} x {scale}"


def _reference_flat(runs, layout, name, i) -> dict:
    key = name.replace("|", "__")
    with np.load(runs["ref"] / f"{_layout_name(layout)}.npz") as z:
        pre = f"{key}__{i}__"
        params = {k: torch.as_tensor(z[f"{pre}p{_key(k)}"])
                  for k in runs["one"][name][i]["params"]}
        mu = {k: torch.as_tensor(z[f"{pre}mu{_key(k)}"])
              for k in runs["one"][name][i]["mu"]}
        return {"params": params, "mu": mu, "loss": float(z[f"{pre}loss"])}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_train_over_model_equals_one_device_and_the_reference(runs, layout,
                                                              name):
    """Both steps' joined loss, parameters and moments on every rank
    within 1e-5 of the one-device step's and within 1e-4 of the
    reference's sharded bundle's; the step moved the parameters."""
    for r, rec in enumerate(_records(runs, layout, name)):
        for i, (params, state, loss) in enumerate(rec["whole"]):
            got = _flat(params, state, loss)
            what = f"{_layout_name(layout)} {name} rank {r} step {i + 1}"
            assert got["step"] == i + 1, what
            _hold(got, runs["one"][name][i], ONE_DEVICE_TOL, what)
            _hold(got, _reference_flat(runs, layout, name, i),
                  REFERENCE_TOL, what + " vs the reference")
    before = runs["inputs"][name][0]
    after = runs["one"][name][1]["params"]
    assert any(not torch.equal(t, after[n]) for n, t in tree_leaves(before))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_pieces_stay_pieces_and_replicated_leaves_stay_equal(runs, layout,
                                                             name):
    """After each step each rank holds its pieces by the placements (the
    one-device parameters cut), every leaf that ``model`` does not split
    is equal bit for bit across the ranks, and no all-gather took a
    weight piece as its input."""
    arch, cell = CASES[name][:2]
    mesh = Mesh(layout, ("data", "model"))
    b = steps.build_step(arch, cell, mesh, reduced=True, opt=_opt(name))
    recs = _records(runs, layout, name)
    p_sh = dict(tree_leaves(b.in_shardings[0]))
    for i in range(2):
        want = runs["one"][name][i]["params"]
        for rec in recs:
            assert rec["weight_gathers"] == 0, (name, rec["coords"])
            for n, piece in tree_leaves(rec["pieces"][i][0]):
                sh = p_sh[n]
                w = want[n]
                for d in range(w.dim()):
                    k = layout[1] if "model" in sh.dim_axes(d) else 1
                    size = w.shape[d] // k
                    start = rec["coords"]["model"] * size if k > 1 else 0
                    w = w.narrow(d, start, size)
                assert piece.shape == w.shape, (name, n)
                err = float((piece.float() - w.float()).abs().max())
                assert err <= ONE_DEVICE_TOL, (name, n, err)
        first = dict(tree_leaves(recs[0]["pieces"][i][0]))
        for rec in recs[1:]:
            for n, t in tree_leaves(rec["pieces"][i][0]):
                if p_sh[n].frac == 1:
                    assert torch.equal(t, first[n]), (name, i + 1, n)


def test_every_model_split_leaf_is_a_piece():
    """Under the LM rules on (1, 4), every weight but the norms is split
    over ``model``; under MIND's, the two tables and the MLP's first
    layer: the pieces the test above holds are real cuts."""
    mesh = Mesh((1, 4), ("data", "model"))
    split = {}
    for arch, cell in (("qwen3-0.6b", "train_4k"), ("mind", "train_batch")):
        b = steps.build_step(arch, cell, mesh, reduced=True)
        split[arch] = sorted(n for n, sh in tree_leaves(b.in_shardings[0])
                             if sh.frac > 1)
    assert split["qwen3-0.6b"] == [
        "embed", "layers.attn.wk", "layers.attn.wo", "layers.attn.wq",
        "layers.attn.wv", "layers.mlp.w_down", "layers.mlp.w_gate",
        "layers.mlp.w_up", "lm_head"]
    assert split["mind"] == ["item_embed", "mlp.b1", "mlp.w1", "mlp.w2",
                             "profile_embed"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_the_autograd_functions_equal_one_device_autograd(runs, layout):
    """``copy_to`` / ``reduce`` around a column-parallel product and
    ``gather`` of it (each rank reading the next rank's columns): the
    loss, the whole gradient of x and each rank's piece of W's gradient
    equal one-device autograd's of ``sum(x @ W * C)``; ``max`` is the
    row maxima over every rank's columns."""
    z = runs["functions"]
    x = z["x"].clone().requires_grad_(True)
    w = z["W"].clone().requires_grad_(True)
    loss = (x @ w * z["C"]).sum()
    gx, gw = torch.autograd.grad(loss, [x, w])
    loss = loss.detach()
    n = w.shape[1] // layout[1]
    out = runs["outs"][_layout_name(layout)]
    for r in range(layout[0] * layout[1]):
        rec = torch.load(out / f"functions_{r}.pt")
        m = rec["coords"]["model"]
        for name in ("copy_reduce", "gather"):
            got = rec[name]
            what = f"{_layout_name(layout)} {name} rank {r}"
            assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(
                float(loss)), what
            torch.testing.assert_close(got["grad_x"], gx, rtol=1e-5,
                                       atol=1e-5, msg=what)
            torch.testing.assert_close(got["grad_w"], gw[:, m * n:(m + 1) * n],
                                       rtol=1e-5, atol=1e-5, msg=what)
        assert torch.equal(rec["max"], (z["x"] @ z["W"]).amax(-1))


# ------------------------------------------------------------ checkpoints
def _next_step(name, state_tree, batch):
    arch, cell = CASES[name][:2]
    b = steps.build_step(arch, cell, reduced=True, opt=_opt(name))
    params, state = state_tree
    return _flat(*b.fn(params, state, *batch))


@pytest.mark.parametrize("layout", [lo for lo in LAYOUTS
                                    if CKPT_MODE[lo] == "restore"],
                         ids=_layout_name)
def test_a_mesh_checkpoint_restores_onto_other_placements(runs, layout):
    """Saved whole from the (1, 2) ranks after step 1, restored onto this
    layout's placements: step 2 within 1e-5 of the uninterrupted
    one-device run, on every rank."""
    want = runs["one"][CKPT_CASE][1]
    for r, rec in enumerate(_records(runs, layout, CKPT_CASE)):
        assert rec["restored_step"] == 1
        got = _flat(*rec["restored"])
        _hold(got, want, ONE_DEVICE_TOL,
              f"{_layout_name(layout)} rank {r} restored")


def test_a_mesh_checkpoint_restores_onto_one_device(runs):
    """The same checkpoint restored whole (``shardings=None``, as
    before): the (1, 2) ranks' joined step 1 leaf for leaf, and step 2
    from it within 1e-5 of the uninterrupted run."""
    params, batches = runs["inputs"][CKPT_CASE]
    like = (_copy(params), adamw_init(_copy(params), _opt(CKPT_CASE)))
    tree, step = checkpoint.restore(str(runs["ckpt"] / CKPT_CASE), like)
    assert step == 1
    saved = _records(runs, (1, 2), CKPT_CASE)[0]["whole"][0]
    for (n, got), (_, want) in zip(tree_leaves(tree[0]),
                                   tree_leaves(saved[0])):
        assert torch.equal(got, want), n
    got = _next_step(CKPT_CASE, tree, batches[1])
    _hold(got, runs["one"][CKPT_CASE][1], ONE_DEVICE_TOL, "one device")


class _RankMesh(Mesh):
    """A mesh seen from one rank, without a process group (restore only
    cuts, it runs no collective)."""

    def __init__(self, shape, rank: int):
        super().__init__(shape, ("data", "model"), [CPU], device_mesh=True)
        self._rank = rank

    @property
    def rank(self) -> int:
        return self._rank


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_a_reference_checkpoint_restores_onto_placements(runs, layout):
    """The reference's checkpoint of its (1, 2) bundle after step 1,
    restored on each rank of ``layout``: every leaf this rank's piece of
    the reference's whole, by the step's placements."""
    params, _ = runs["inputs"][CKPT_CASE]
    like = (_copy(params), adamw_init(_copy(params), _opt(CKPT_CASE)))
    want = _reference_flat(runs, (1, 2), CKPT_CASE, 0)
    for r in range(layout[0] * layout[1]):
        mesh = _RankMesh(layout, r)
        b = steps.build_step(CKPT_CASE, "train_4k", mesh, reduced=True,
                             opt=_opt(CKPT_CASE))
        (p, s), step = checkpoint.restore(str(runs["ref"] / "ckpt"), like,
                                          shardings=b.in_shardings[:2])
        assert step == 1 and int(s["step"]) == 1
        for (n, got), (_, sh) in zip(tree_leaves(p),
                                     tree_leaves(b.in_shardings[0])):
            assert torch.equal(got, steps._piece(want["params"][n], sh)), n
        for (n, got), (_, sh) in zip(tree_leaves(s["mu"]),
                                     tree_leaves(b.in_shardings[1]["mu"])):
            assert got.shape == steps._piece(want["mu"][n], sh).shape, n
            assert torch.equal(got, steps._piece(want["mu"][n], sh)), n


# ------------------------------------------------------ int8 moments
@pytest.mark.parametrize("M", [2, 4])
def test_int8_moments_of_pieces(M):
    """``adamw_update`` of each of M column pieces of a parameter whose
    int8 blocks run across the pieces' seams (96 columns a row, blocks of
    128), over two steps from the same gradients: every piece's parameter
    and the moments' codes and scales equal the whole parameter's update
    bit for bit.  ``join`` stands in for the all-gather: the other pieces'
    moments are the whole update's."""
    from repro_torch.optim import Piece, adamw_update, q8_decode

    rng = np.random.default_rng(M)
    shape, n = (6, 96), 96 // M
    opt = AdamWConfig(lr=LR, quantize_moments=True)
    p0 = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    grads = [torch.as_tensor(rng.normal(size=shape).astype(np.float32))
             for _ in range(2)]
    whole = {"w": p0.clone()}
    state = adamw_init(whole, opt)
    states = [adamw_init({"w": p0[:, r * n:(r + 1) * n].clone()}, opt)
              for r in range(M)]
    for r in range(M):
        states[r]["mu"]["w"] = {k: v.clone() for k, v in
                                state["mu"]["w"].items()}
    pieces = [{"w": p0[:, r * n:(r + 1) * n].clone()} for r in range(M)]
    for g in grads:
        prev = {k: v.clone() for k, v in state["mu"]["w"].items()}
        adamw_update(whole, [g], state, opt)
        after = {key: q8_decode(state["mu"]["w"][key + "_q"],
                                state["mu"]["w"][key + "_s"], shape)
                 for key in ("m", "v")}
        for r in range(M):
            cols = slice(r * n, (r + 1) * n)
            calls = iter(("m", "v"))

            def join(x, cols=cols, calls=calls):
                out = after[next(calls)].clone()
                out[:, cols] = x
                return out

            st = states[r]
            st["mu"]["w"] = {k: v.clone() for k, v in prev.items()}
            adamw_update(pieces[r], [g[:, cols]], st, opt,
                         {"w": Piece(shape, lambda x, c=cols: x[:, c],
                                     join)})
            assert torch.equal(pieces[r]["w"], whole["w"][:, cols]), r
            for k, v in state["mu"]["w"].items():
                assert torch.equal(st["mu"]["w"][k], v), (r, k)
