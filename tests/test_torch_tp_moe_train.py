"""MoE, MLA and MTP training over a ``model`` axis wider than 1 (one data
rank), against the one-device step and the JAX package.

The port's ranks are gloo processes on the CPU
(``torch_pg_ranks.tp_train_cases``, which imports no JAX), started once
per mesh layout ``(1, M)`` in :data:`LAYOUTS` with every case in that one
start; the reference's bundles run jitted with their shardings on 4
forced host devices, a subprocess a layout, beside them
(``test_torch_tp_train``'s script).  Each case takes two ``train_4k``
steps of the ``reduced()`` config in float32 at lr 1e-3 (AdamW's eps
1e-4, ``test_torch_tp_train.EPS``), each from the one-device run's state
before it, from parameters drawn with numpy (norm weights off their
ones): DeepSeek-V3 (MLA, a dense prefix layer, a shared expert, MTP),
once with float32 moments and once with int8; Arctic (GQA with ``n_kv =
2``, so (1, 4) gathers k and v whole, a dense residual MLP), once as
drawn and once with its router skewed so that every rank's experts take
more than their capacity.  Loss, every parameter and every moment after
each step are held within 1e-5 of the one-device step and within 1e-4 of
the reference's; every rank routes every MoE call (the forward and its
recompute) as one device does; every leaf that ``model`` does not split
(the router, MLA's ``wq_a``, ``wkv_a`` and norms, MTP's ``proj`` and
norms) is equal bit for bit on every rank.
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
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from test_torch_tp_train import (EPS, LR, ONE_DEVICE_TOL,  # noqa: E402
                                 REFERENCE_TOL, _REFERENCE, _copy, _flat,
                                 _hold, _key, _state_copy, draw_params)
from torch_pg_ranks import _RouteSpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
DSV3, ARCTIC = "deepseek-v3-671b", "arctic-480b"
LAYOUTS = ((1, 2), (1, 4))
#: name -> (arch, int8 moments, router skewed)
CASES = {"deepseek-v3": (DSV3, False, False),
         "deepseek-v3|q8": (DSV3, True, False),
         "arctic": (ARCTIC, False, False),
         "arctic|skewed": (ARCTIC, False, True)}
#: the skewed case's router: experts 0 and 4 take the columns +-s u,
#: experts 2 and 6 +-s v (unit u, v drawn from SKEW_SEED in each layer),
#: two on each rank of (1, 2), one on each rank of (1, 4).  A token's
#: logits there, +-s x.u and +-s x.v, pass the other experts' nearly always,
#: so its top 2 are one of each pair; with this seed every one of the four
#: takes more than its capacity in every MoE call (held below; about a
#: quarter of the seeds do, as x.u leans to one side).  Columns of norm s = 3 (the others ~0.8)
#: keep the router's share of the input's gradient, summed in another
#: order on the ranks, near float32's rounding (a column scaled by 30 made
#: both one device's embedding gradient and the ranks' stray 5e-6 of its
#: largest from a more precise sum)
SKEWED_EXPERTS, SKEW_NORM, SKEW_SEED = (0, 2, 4, 6), 3.0, 3


def _layout_name(layout) -> str:
    return "x".join(map(str, layout))


def opt_kw(q8: bool) -> dict:
    return {"lr": LR, "eps": EPS, "quantize_moments": q8}


def lm_batches(arch: str, rows: int, seed: int, n: int = 2) -> list:
    """``n`` seeded (tokens, labels) batches of ``rows`` rows of the
    reduced train_4k cell's length, labels the next tokens."""
    cfg = get_config(arch).reduced()
    (_, S), _ = steps.build_step(arch, "train_4k", reduced=True).args[2]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab, (rows, S + 1)).astype(np.int32)
        out.append((torch.as_tensor(tok[:, :-1]),
                    torch.as_tensor(tok[:, 1:])))
    return out


def skew(params) -> None:
    """Give :data:`SKEWED_EXPERTS` their skewed router columns in place."""
    r = params["layers"]["moe"]["router"]
    g = torch.Generator().manual_seed(SKEW_SEED)
    uv = torch.randn((r.shape[0], r.shape[1], 2), generator=g)
    uv = uv / uv.norm(dim=1, keepdim=True) * SKEW_NORM
    a, b, c, d = SKEWED_EXPERTS
    r[..., a], r[..., c] = uv[..., 0], -uv[..., 0]
    r[..., b], r[..., d] = uv[..., 1], -uv[..., 1]


def one_device(bundle, params, batches) -> tuple:
    """``bundle``'s one-device run from fresh AdamW state: the whole
    ``(params, state)`` before each step, its outputs flattened after each
    (:func:`test_torch_tp_train._flat`), and the routes of each step's MoE
    calls (the forward and the recompute)."""
    params = _copy(params)
    state = adamw_init(params, bundle.static["opt"])
    before, after, routes = [], [], []
    for batch in batches:
        before.append((_copy(params), _state_copy(state)))
        with _RouteSpy() as rs:
            params, state, loss = bundle.fn(params, state, *batch)
        after.append(_flat(params, state, loss))
        routes.append(rs.routes)
    return before, after, routes


def save_case(path_pt, path_npz, before, batches) -> None:
    """A case's states and batches for the ranks (``.pt``) and for the
    reference (``.npz``, as ``test_torch_tp_train``'s script reads
    them)."""
    torch.save({"states": before, "batches": batches}, path_pt)
    flat = {}
    for i, (batch, (p, st)) in enumerate(zip(batches, before)):
        flat.update({f"b{i}.tokens": batch[0].numpy(),
                     f"b{i}.labels": batch[1].numpy()})
        flat.update({f"p{i}.{n}": t.numpy() for n, t in tree_leaves(p)})
        flat.update({f"mu{i}.{n}": t.numpy()
                     for n, t in tree_leaves(st["mu"])})
        flat[f"step{i}"] = st["step"].numpy()
    np.savez(path_npz, **flat)


def reference_flat(z, key: str, i: int, one: dict) -> dict:
    """Step ``i`` of a case from the reference's npz ``z``, under the
    port's leaf names."""
    pre = f"{key}__{i}__"
    return {"params": {k: torch.as_tensor(z[f"{pre}p{_key(k)}"])
                       for k in one["params"]},
            "mu": {k: torch.as_tensor(z[f"{pre}mu{_key(k)}"])
                   for k in one["mu"]},
            "loss": float(z[f"{pre}loss"])}


def reference_env(devices: int = 4, **extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
        **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device runs, the ranks' runs (one start a layout) and the
    reference's sharded bundles (a subprocess a layout, beside them)."""
    case_dir = tmp_path_factory.mktemp("tp_moe_train_cases")
    ref_dir = tmp_path_factory.mktemp("tp_moe_train_reference")
    one, inputs = {}, {}
    for seed, (name, (arch, q8, skewed)) in enumerate(CASES.items()):
        b = steps.build_step(arch, "train_4k", reduced=True,
                             opt=AdamWConfig(**opt_kw(q8)))
        params = draw_params(b.static["pspecs"], 60 + seed)
        if skewed:
            skew(params)
        batches = lm_batches(arch, 2, 80 + seed)
        before, after, routes = one_device(b, params, batches)
        one[name] = {"after": after, "routes": routes}
        inputs[name] = (params, batches)
        key = name.replace("|", "__")
        save_case(case_dir / f"{name}.pt", case_dir / f"{key}.npz", before,
                  batches)
    (case_dir / "ref_cases.json").write_text(json.dumps(
        {n: (a, "train_4k", opt_kw(q8), False)
         for n, (a, q8, _) in CASES.items()}))
    (case_dir / "cases.json").write_text(json.dumps(
        {n: {"arch": a, "shape": "train_4k", "opt": opt_kw(q8),
             "ckpt": False} for n, (a, q8, _) in CASES.items()}))
    (case_dir / "layouts.json").write_text(json.dumps(
        {_layout_name(lo): lo for lo in LAYOUTS}))
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, case_dir,
                              ref_dir, _layout_name(layout)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=reference_env(), cwd=ROOT)
            for layout in LAYOUTS]
    outs = {}
    try:
        def start(layout):
            out = tmp_path_factory.mktemp(
                f"tp_moe_train_ranks_{_layout_name(layout)}")
            run_ranks("torch_pg_ranks:tp_train_cases",
                      layout[0] * layout[1], backend="gloo",
                      args=[case_dir, out, *layout, "none:"],
                      paths=[TESTS], timeout=600,
                      env={"OMP_NUM_THREADS": "1"})
            outs[_layout_name(layout)] = out

        with ThreadPoolExecutor(len(LAYOUTS)) as pool:
            for done in [pool.submit(start, lo) for lo in LAYOUTS]:
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
    return {"one": one, "inputs": inputs, "outs": outs, "ref": ref_dir}


def _records(runs, layout, name) -> list:
    out = runs["outs"][_layout_name(layout)]
    return [torch.load(out / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_moe_train_over_model_equals_one_device_and_the_reference(
        runs, layout, name):
    """Both steps' joined loss, parameters and moments on every rank
    within 1e-5 of the one-device step's and within 1e-4 of the
    reference's sharded bundle's; the steps moved the parameters.  Fails
    without *f* on the router (a rank's gates reach its own experts, so
    the router's gradient and the one through its logits are a rank's
    partial) and with *f* on the attention's input alone in MLA (``wq_a``,
    ``wkv_a`` and both norms then keep one rank's partial)."""
    lname = _layout_name(layout)
    with np.load(runs["ref"] / f"{lname}.npz") as z:
        ref = [reference_flat(z, name.replace("|", "__"), i,
                              runs["one"][name]["after"][i])
               for i in range(2)]
    for r, rec in enumerate(_records(runs, layout, name)):
        for i, (params, state, loss) in enumerate(rec["whole"]):
            got = _flat(params, state, loss)
            what = f"{lname} {name} rank {r} step {i + 1}"
            assert got["step"] == i + 1, what
            _hold(got, runs["one"][name]["after"][i], ONE_DEVICE_TOL, what)
            _hold(got, ref[i], REFERENCE_TOL, what + " vs the reference")
    before = runs["inputs"][name][0]
    after = runs["one"][name]["after"][1]["params"]
    assert any(not torch.equal(t, after[n]) for n, t in tree_leaves(before))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_whole_leaves_stay_equal_and_pieces_stay_pieces(runs, layout, name):
    """After each step each rank holds its pieces by the placements (the
    one-device parameters cut, within 1e-5, the experts
    ``[r * X / M, (r + 1) * X / M)`` among them), every leaf that
    ``model`` does not split is equal bit for bit across the ranks, and no
    all-gather took a weight as its input."""
    arch, q8, _ = CASES[name]
    b = steps.build_step(arch, "train_4k", Mesh(layout, ("data", "model")),
                         reduced=True, opt=AdamWConfig(**opt_kw(q8)))
    p_sh = dict(tree_leaves(b.in_shardings[0]))
    recs = _records(runs, layout, name)
    whole = [n for n, sh in p_sh.items() if sh.frac == 1]
    assert {"layers.moe.router"} <= set(whole)
    if arch == DSV3:
        assert {"layers.attn.wq_a", "layers.attn.wkv_a", "layers.attn.q_norm",
                "layers.attn.kv_norm", "mtp.proj", "mtp.ln_in",
                "mtp.ln_prev"} <= set(whole)
    for i in range(2):
        want = runs["one"][name]["after"][i]["params"]
        for rec in recs:
            assert rec["weight_gathers"] == 0, (name, rec["coords"])
            for n, piece in tree_leaves(rec["pieces"][i][0]):
                w = want[n]
                for d in range(w.dim()):
                    k = layout[1] if "model" in p_sh[n].dim_axes(d) else 1
                    size = w.shape[d] // k
                    w = w.narrow(d, rec["coords"]["model"] * size
                                 if k > 1 else 0, size)
                assert piece.shape == w.shape, (name, n)
                err = float((piece.float() - w.float()).abs().max())
                assert err <= ONE_DEVICE_TOL, (name, n, err)
        first = dict(tree_leaves(recs[0]["pieces"][i][0]))
        for rec in recs[1:]:
            got = dict(tree_leaves(rec["pieces"][i][0]))
            for n in whole:
                assert torch.equal(got[n], first[n]), (name, i + 1, n)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_every_rank_routes_as_one_device(runs, layout, name):
    """Every MoE call of each step (the forward and its recompute in the
    backward) routes its tokens to the one device's experts on every
    rank, with no batch split (one data rank)."""
    want = runs["one"][name]["routes"]
    for r, rec in enumerate(_records(runs, layout, name)):
        for i in range(2):
            got = rec["routes"][i]
            assert len(got) == len(want[i]) > 0, (name, r, i)
            for a, e in zip(got, want[i]):
                assert torch.equal(a, e), (name, r, i)
            assert set(rec["splits"][i]) == {None}, (name, r, i)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_skewed_router_drops_on_every_ranks_experts(runs, layout):
    """The skewed case's precondition: in each step's MoE layer every
    rank's experts take more assignments than their capacity, so the
    stable sort decides which are dropped on every rank, and the ranks
    train on the one device's choice (held above)."""
    cfg = get_config(ARCTIC).reduced()
    X, M = cfg.moe.num_experts, layout[1]
    for routes in runs["one"]["arctic|skewed"]["routes"]:
        for e in routes:
            over = (torch.bincount(e.reshape(-1), minlength=X)
                    - moe_capacity(cfg.moe, e.shape[0])).clamp(min=0)
            assert all(int(over[r * X // M:(r + 1) * X // M].sum()) > 0
                       for r in range(M)), over


class _OneRank:
    """The collectives of a group of one rank: the sum is the input."""

    @staticmethod
    def all_reduce(x, op="sum"):
        return x.clone()


@pytest.mark.parametrize("widths", [(24, 8, 8), (40,)])
def test_columns_under_autograd_sum_float32_partials(widths):
    """``TensorParallel.columns`` under autograd (``layers._Columns``, a
    group of one rank), the same code the card runs: the forward is each
    ``x @ w`` bit for bit, each weight's gradient autograd's, and ``x``'s
    gradient the products ``g @ w.T`` added (float32 here, as on the
    card before the one rounding)."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(len(widths))
    x0 = torch.randn((2, 5, 16), generator=g)
    ws0 = [torch.randn((16, n), generator=g) for n in widths]
    cots = [torch.randn((2, 5, n), generator=g) for n in widths]
    tp = layers.TensorParallel(_OneRank(), 1, 0)
    x = x0.clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in ws0]
    outs = tp.columns(x, *ws)
    for y, w in zip(outs, ws0):
        assert torch.equal(y.detach(), x0 @ w)
    got = torch.autograd.grad(outs, [x, *ws], cots)
    want_x = sum(c @ w.t() for c, w in zip(cots, ws0))
    torch.testing.assert_close(got[0], want_x, rtol=1e-6, atol=1e-6)
    auto = torch.autograd.grad([x0 @ w for w in ws], ws, cots)
    for a, b in zip(got[1:], auto):
        assert torch.equal(a, b)
    assert all(y.grad_fn is None for y in tp.columns(x0, *ws0))
