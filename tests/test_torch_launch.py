"""The port's ``launch/``: meshes, the core-graph cells, placements and
per-chip bytes, data-parallel train steps over a process group, and the
dry run, against the JAX package.

The port's ranks are gloo processes on the CPU (their code is
``torch_pg_ranks.py``, which imports no JAX).  The reference runs in
subprocesses on forced host devices: its train steps on
``make_host_mesh(max_data=2)`` over 2, its bundles (built, never
compiled) on the production meshes over 512.
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

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.data import RecsysSource  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh, use_mesh,
                                     current_mesh)
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.params import (tree_init, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

from test_torch_gnn import cell_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
CPU = torch.device("cpu")


def _reference(code: str, *args, devices: int) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


# ------------------------------------------------------------------ meshes
def test_host_mesh_without_a_process_group():
    m = make_host_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.devices == [CPU] and m.device_mesh is None
    assert make_host_mesh(max_data=None, device="cpu").shape["data"] == 1
    assert m.coords() == {"data": 0, "model": 0}
    with pytest.raises(RuntimeError, match="no process group"):
        m.get_group("data")


def test_host_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert m.shape == want and m.size == (512 if multi_pod else 256)
    assert m.devices == [] and m.device_mesh is None
    assert m.axis_size(("pod", "data") if multi_pod else "data") == \
        (32 if multi_pod else 16)


def test_use_mesh_nests():
    a, b = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert current_mesh() is None
    with use_mesh(a):
        with use_mesh(b):
            assert current_mesh() is b
        assert current_mesh() is a
    assert current_mesh() is None


def test_train_loop_takes_a_one_rank_host_mesh():
    from repro_torch.train import TrainLoop

    loop = TrainLoop("gcn-cora", device="cpu")
    assert loop.mesh.shape == {"data": 1, "model": 1}
    assert loop.mesh.devices == [CPU]
    assert loop.bundle.in_shardings is not None


# -------------------------------------------------------- core-graph cells
def test_cell_tables_match_the_reference():
    assert shapes.COREGRAPH_SHAPES == jshapes.COREGRAPH_SHAPES
    assert set(shapes.SHAPES_BY_KIND) == set(jshapes.SHAPES_BY_KIND)
    for kind, table in shapes.SHAPES_BY_KIND.items():
        assert table == jshapes.SHAPES_BY_KIND[kind], kind
    for arch in [*ARCH_IDS, "semicore-webscale"]:
        assert shapes.shape_names(get_config(arch)) == \
            jshapes.shape_names(jget(arch)), arch


@pytest.mark.parametrize("num_shards", [1, 3, 256, 512])
@pytest.mark.parametrize("reduced", [False, True])
def test_coregraph_input_specs_match_the_reference(num_shards, reduced):
    cfg, jcfg = get_config("semicore-webscale"), jget("semicore-webscale")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    kind, av = shapes.input_specs(cfg, "decompose", num_shards=num_shards)
    jkind, jav = jshapes.input_specs(jcfg, "decompose",
                                     num_shards=num_shards)
    assert kind == jkind == "decompose"
    assert av["num_probes"] == jav["num_probes"]
    assert set(av["specs"]) == set(jav["specs"])
    for k, (shape, dtype) in av["specs"].items():
        js = jav["specs"][k]
        assert shape == tuple(js.shape), k
        assert str(dtype).split(".")[-1] == str(js.dtype).replace(
            "bool", "bool"), k
    with pytest.raises(KeyError):
        shapes.input_specs(cfg, "nope")


def test_build_step_returns_for_every_kind_on_a_mesh():
    host = make_host_mesh(device="cpu")
    b = steps.build_step("qwen3-0.6b", "train_4k", host, reduced=True)
    assert b.name == "train_step" and b.in_shardings is not None
    assert b.donate_argnums == (0, 1)
    cell = steps.build_step("semicore-webscale", "decompose",
                            make_production_mesh())
    assert cell.name == "decompose" and len(cell.args) == 10
    assert cell.args[4][0] == shapes.input_specs(
        get_config("semicore-webscale"), "decompose",
        num_shards=256)[1]["specs"]["dst"][0]
    with pytest.raises(RuntimeError, match="no devices"):
        cell.fn(None, None, None, None, None)
    # a production mesh describes placements only
    big = steps.build_step("qwen3-0.6b", "train_4k", make_production_mesh(),
                           reduced=True)
    with pytest.raises(RuntimeError, match="no process group"):
        big.fn(None, None, None, None)


def test_local_args_refuse_a_size_the_ranks_do_not_divide():
    """An odd edge count over 2 ranks is refused, as the reference's
    ``NamedSharding`` refuses it; an even one is cut in halves."""
    mesh = Mesh((2, 1), ("data", "model"), devices=["cpu"])
    b = steps.build_step("gcn-cora", "full_graph_sm", mesh, reduced=True)
    cfg = get_config("gcn-cora").reduced()
    batch, _ = cell_inputs(cfg, "full_graph_sm", seed=2)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    e = tb["src"].shape[0]
    for k in ("src", "dst"):
        tb[k] = tb[k][: e - 1 if e % 2 == 0 else e]
    with pytest.raises(ValueError, match="does not divide over the 2"):
        steps.local_args(b, None, None, tb)
    for k in ("src", "dst"):
        tb[k] = tb[k][:-1]
    _, _, piece = steps.local_args(b, None, None, tb)
    assert piece["src"].shape[0] == tb["src"].shape[0] // 2
    assert torch.equal(piece["dst"], tb["dst"][: tb["dst"].shape[0] // 2])


def test_accum_steps_keep_the_microbatch_shardable():
    assert steps.accum_steps(256, 4096) == 128
    assert steps.accum_steps(256, 4096, 16) == 8
    assert steps.accum_steps(256, 4096, 256) == 1
    assert steps.accum_steps(8, 4096, 2) == 2
    assert steps.accum_steps(6, 8192, 4) == 1  # no microbatch splits 4 ways


# ------------------------------------------------ data-parallel train steps
TRAIN_CASES = {
    "lm": ("qwen3-0.6b", "train_4k", 1e-3),
    "mind": ("mind", "train_batch", 1e-3),
    "gcn": ("gcn-cora", "full_graph_sm", 1e-3),
    "sage": ("graphsage-reddit", "minibatch_lg", 1e-3),
    "schnet": ("schnet", "molecule", 1e-3),
    "egnn": ("egnn", "ogb_products", 1e-3),
}

_REFERENCE_TRAIN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
assert len(jax.devices()) == 2
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.launch.steps import build_step
from repro.optim import AdamWConfig, adamw_init

case_dir, out = sys.argv[1], sys.argv[2]
cases = json.load(open(f"{case_dir}/cases.json"))

def nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return tree

mesh = make_host_mesh(max_data=2)
for name, (arch, shape, lr) in cases.items():
    z = np.load(f"{case_dir}/{name}.npz")
    params = nest({k[2:]: z[k] for k in z.files if k.startswith("p.")})
    batch = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("b.")}
    b = build_step(arch, shape, mesh, reduced=True, opt=AdamWConfig(lr=lr))
    state = adamw_init(params, b.static["opt"])
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    with use_mesh(mesh):
        if "tokens" in batch:
            p2, s2, loss = fn(params, state, batch["tokens"], batch["labels"])
        else:
            p2, s2, loss = fn(params, state, batch)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(p2)[0]}
    flat.update({"mu" + jax.tree_util.keystr(k): np.asarray(v)
                 for k, v in jax.tree_util.tree_flatten_with_path(
                     s2["mu"])[0]})
    np.savez(f"{out}/{name}.npz", loss=np.asarray(loss), **flat)
print("REFERENCE_TRAIN_OK")
"""


def _train_inputs(name, arch, shape):
    """Global params (seeded), fresh AdamW state and a seeded batch."""
    cfg = get_config(arch).reduced()
    b = steps.build_step(arch, shape, reduced=True)
    params = tree_init(b.static["pspecs"], torch.Generator().manual_seed(5))
    if cfg.kind == "lm":
        rng = np.random.default_rng(9)
        (B, S), _ = b.args[2]
        tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    elif cfg.kind == "recsys":
        batch = RecsysSource(cfg, 4, seed=4)(2)
    else:
        batch, _ = cell_inputs(cfg, shape, seed=2)
    flat = {n: t.detach().clone() for n, t in tree_leaves(params)}
    return cfg, params, batch, flat


def _step_args(cfg, params, batch, opt):
    """The step's arguments: a copy of ``params`` as nested dicts, fresh
    AdamW state and the batch as tensors."""
    params = tree_map(lambda t: t.detach().clone(), params)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    state = adamw_init(params, opt)
    if cfg.kind == "lm":
        return (params, state, tb["tokens"], tb["labels"])
    return (params, state, tb)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Each case's inputs, its one-device step and its two-rank step (one
    start of 2 gloo ranks for every case), and the reference's."""
    case_dir = tmp_path_factory.mktemp("train_cases")
    out = tmp_path_factory.mktemp("train_ranks")
    ref = tmp_path_factory.mktemp("train_reference")
    one = {}
    for name, (arch, shape, lr) in TRAIN_CASES.items():
        opt = AdamWConfig(lr=lr)
        cfg, params, batch, flat = _train_inputs(name, arch, shape)
        np.savez(case_dir / f"{name}.npz",
                 **{f"p.{k}": v.numpy() for k, v in flat.items()},
                 **{f"b.{k}": np.asarray(v) for k, v in batch.items()})
        torch.save(_step_args(cfg, params, batch, opt),
                   case_dir / f"{name}.pt")
        b = steps.build_step(arch, shape, reduced=True, opt=opt)
        p2, s2, loss = b.fn(*_step_args(cfg, params, batch, opt))
        one[name] = ({n: t.detach().clone() for n, t in tree_leaves(p2)},
                     float(loss), flat,
                     {n: t.clone() for n, t in tree_leaves(s2["mu"])})
    (case_dir / "cases.json").write_text(json.dumps(TRAIN_CASES))
    run_ranks("torch_pg_ranks:train_cases", 2, backend="gloo",
              args=[case_dir, out],
              paths=[TESTS], timeout=600, env={"OMP_NUM_THREADS": "1"})
    _reference(_REFERENCE_TRAIN, case_dir, ref, devices=2)
    return one, out, ref


def _key(name: str) -> str:
    return "".join(f"[{part!r}]" for part in name.split("."))


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_data_parallel_step_equals_one_device_and_the_reference(train_runs,
                                                                name):
    one, out, ref = train_runs
    want, want_loss, before, want_mu = one[name]
    got = torch.load(out / f"{name}.pt")
    got_params = {k: v.detach() for k, v in tree_leaves(got["params"])}
    assert set(got_params) == set(want)
    moved = 0
    for k, w in want.items():
        g = got_params[k]
        assert float((g - w).abs().max()) <= 1e-5, (name, k)
        moved += int(not torch.equal(w, before[k]))
    assert moved  # the step changed the parameters
    assert abs(float(got["loss"]) - want_loss) <= 1e-5 * max(1, want_loss)
    with np.load(ref / f"{name}.npz") as z:
        for k, g in got_params.items():
            r = z[_key(k)]
            assert np.abs(g.numpy() - r).max() <= 1e-4, (name, k)
        assert abs(float(got["loss"]) - float(z["loss"])) <= 1e-4 * max(
            1, abs(float(z["loss"])))
    # The moments carry the averaged gradient's scale, which the first
    # AdamW update (about lr * sign(g)) does not: each leaf is held
    # relative to its largest moment.
    got_mu = dict(tree_leaves(got["state"]["mu"]))
    assert set(got_mu) == set(want_mu)
    with np.load(ref / f"{name}.npz") as z:
        for k, w in want_mu.items():
            g = got_mu[k].float()
            w = w.float()
            r = torch.as_tensor(z["mu" + _key(k)]).float()
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-5 * scale, (name, k)
            assert float((g - r).abs().max()) <= 1e-4 * scale, (name, k)
    assert any(float(w.abs().max()) > 0 for w in want_mu.values())


def test_data_parallel_state_is_cut_by_its_placements(train_runs):
    """Every case's AdamW state came back whole from the ranks' pieces,
    one step on (its moments are held in the test above); the LM case's
    moments are cut by ZeRO-1, embed dims over data."""
    _, out, _ = train_runs
    for name in TRAIN_CASES:
        got = torch.load(out / f"{name}.pt")
        mu = dict(tree_leaves(got["state"]["mu"]))
        assert int(got["state"]["step"]) == 1, name
        assert all(torch.isfinite(v.float()).all() for v in mu.values())
    b = steps.build_step("qwen3-0.6b", "train_4k", make_production_mesh(),
                         reduced=True)
    specs = dict(tree_leaves(b.in_shardings[1]["mu"]))
    assert any(s.spec and "data" in (s.dim_axes(0) + s.dim_axes(1))
               for s in specs.values())


# ---------------------------------------------- placements and chip bytes
_REFERENCE_PLACEMENTS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding
assert len(jax.devices()) == 512
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_step

def norm(e):
    if e is None:
        return None
    if isinstance(e, tuple):
        return list(e) if len(e) > 1 else e[0]
    return e

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    chips = 512 if multi else 256
    for arch, shape in dryrun.all_cells():
        b = build_step(arch, shape, mesh)
        leaves = []
        if b.in_shardings is not None:
            for i, (av, sh) in enumerate(zip(b.args, b.in_shardings)):
                for (path, a), s in zip(
                        jax.tree_util.tree_flatten_with_path(av)[0],
                        jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))):
                    spec = [norm(e) for e in s.spec]
                    spec += [None] * (len(a.shape) - len(spec))
                    leaves.append([i, jax.tree_util.keystr(path), spec])
        outs = []
        if b.out_shardings is not None:
            for s in jax.tree.leaves(b.out_shardings,
                                     is_leaf=lambda x: hasattr(x, "spec")):
                outs.append([norm(e) for e in s.spec])
        mm = dryrun._memory_model(arch, shape, mesh, b, chips)
        out[f"{arch}|{shape}|{int(multi)}"] = {
            "in": leaves, "out": outs,
            "args": dryrun._args_bytes_per_chip(b), "mem": mm,
            "donate": list(b.donate_argnums), "num_params": b.num_params}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_PLACEMENTS_OK")
"""


@pytest.fixture(scope="module")
def reference_placements(tmp_path_factory):
    path = tmp_path_factory.mktemp("placements") / "ref.json"
    _reference(_REFERENCE_PLACEMENTS, path, devices=512)
    return json.loads(path.read_text())


def _norm_spec(sh, ndim):
    spec = []
    for d in range(ndim):
        axes = sh.dim_axes(d)
        spec.append(None if not axes else
                    axes[0] if len(axes) == 1 else list(axes))
    return spec


def _leaves_with_keys(tree):
    """(keystr, leaf) of a (shape, dtype) tree in flatten order."""
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(
            tree[0], tuple):
        return [("", tree)]
    return [(_key(n), v) for n, v in tree_leaves(tree)]


def _sharding_leaves(tree):
    from repro_torch.launch.mesh import Sharding

    if isinstance(tree, Sharding):
        return [tree]
    return [v for _, v in tree_leaves(tree)]


@pytest.mark.parametrize("multi", [0, 1])
def test_placements_and_chip_bytes_match_the_reference(reference_placements,
                                                       multi):
    mesh = make_production_mesh(multi_pod=bool(multi))
    chips = mesh.size
    for arch, shape in dryrun.all_cells():
        want = reference_placements[f"{arch}|{shape}|{multi}"]
        b = steps.build_step(arch, shape, mesh)
        what = f"{arch} {shape} multi={multi}"
        got = []
        if b.in_shardings is not None:
            for i, (av, sh) in enumerate(zip(b.args, b.in_shardings)):
                avs = _leaves_with_keys(av)
                shs = _sharding_leaves(sh)
                if len(shs) == 1 and len(avs) > 1:
                    shs = shs * len(avs)
                assert len(avs) == len(shs), what
                for (k, a), s in zip(avs, shs):
                    got.append([i, k, _norm_spec(s, len(a[0]))])
        assert got == want["in"], what
        assert got or arch == "semicore-webscale", what
        outs = []
        if b.out_shardings is not None:
            for o in (b.out_shardings if isinstance(b.out_shardings, tuple)
                      else (b.out_shardings,)):
                outs += [_norm_spec(s, len(s.spec))
                         for s in _sharding_leaves(o)]
        assert outs == want["out"], what
        assert list(b.donate_argnums) == want["donate"], what
        assert b.num_params == want["num_params"], what
        assert dryrun.args_bytes_per_chip(b) == pytest.approx(
            want["args"], rel=1e-12), what
        mm = dryrun.memory_model(arch, shape, mesh, b, chips)
        for k, v in want["mem"].items():
            if isinstance(v, bool):
                continue
            assert mm[k] == pytest.approx(v, rel=1e-12), (what, k)


# -------------------------------------------------------------- dry run
def _lm_matmul_flops(cfg, B, S, T, step: str) -> float:
    """Matmul FLOPs of a dense LM's serving step (no MoE, no MLA): the
    q/k/v/o projections and the SwiGLU MLP of each layer for B x S
    tokens; attention scores and values over T keys a row (prefill:
    chunked attention's one live chunk of 1,024 keys, zero-padded past
    S; decode: the whole cache); the vocabulary head of one position a
    row."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    tok = B * S
    per_layer = 2 * tok * d * (h * hd + 2 * kv * hd) + 2 * tok * h * hd * d \
        + 3 * 2 * tok * d * cfg.d_ff + 2 * 2 * B * h * S * T * hd
    return cfg.n_layers * per_layer + 2 * B * d * cfg.vocab


def _gcn_matmul_flops(cfg, N, F, train: bool) -> float:
    dims = [F] + [cfg.d_hidden] * cfg.n_layers
    fwd = sum(2 * N * a * b for a, b in zip(dims[:-1], dims[1:])) \
        + 2 * N * cfg.d_hidden * cfg.num_classes
    # backward: the input's gradient is not needed at layer 0
    bwd = 2 * fwd - 2 * N * dims[0] * dims[1]
    return fwd + bwd if train else fwd


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-0.6b", "prefill_32k"), ("qwen3-0.6b", "decode_32k"),
    ("gcn-cora", "full_graph_sm"), ("mind", "serve_p99"),
    ("semicore-webscale", "decompose")])
def test_dry_run_flops_match_an_analytic_count(arch, shape):
    rec = dryrun.run_cell(arch, shape, make_production_mesh(), "single", 256,
                          reduced=True)
    assert rec["ok"] and rec["memory_model"]["fits_80GB_hbm"]
    cfg = get_config(arch).reduced()
    if cfg.kind == "lm":
        _, av = shapes.input_specs(cfg, shape, reduced=True)
        if shape == "prefill_32k":
            B, S = av["tokens"][0]
            want = _lm_matmul_flops(cfg, B, S, 1024, shape)
        else:
            B, T = av["caches"]["k"][0][1:3]
            want = _lm_matmul_flops(cfg, B, 1, T, shape)
    elif cfg.kind == "gnn":
        _, av = shapes.input_specs(cfg, shape, reduced=True)
        N = av["num_nodes"]
        want = _gcn_matmul_flops(cfg, N, av["batch"]["x"][0][-1], True)
    elif cfg.kind == "recsys":
        # MIND serve: the bilinear map, each routing iteration's two
        # batched products, the profile bags' weighted sums, the profile
        # projection and the two MLP layers over K interests
        B, D, L, K = 4, cfg.embed_dim, cfg.hist_len, cfg.n_interests
        nf, mlp = cfg.n_profile_fields, cfg.mlp_dim
        want = 2 * B * L * D * D + cfg.capsule_iters * 2 * (2 * B * K * L * D) \
            + 2 * B * nf * cfg.profile_bag * D + 2 * B * nf * D * D \
            + 2 * B * K * 2 * D * mlp + 2 * B * K * mlp * D
    else:
        want = 0.0
    got = rec["flops_total"]
    assert got == pytest.approx(want, rel=0.01, abs=1.0), (got, want)


def test_dry_run_writes_every_cell_on_both_meshes(tmp_path):
    cells = dryrun.all_cells()
    assert len(cells) == 41 and cells[-1] == ("semicore-webscale",
                                              "decompose")
    rc = dryrun.main(["--out", str(tmp_path), "--mesh", "both",
                      "--arch", "semicore-webscale"])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 2 and all(r["ok"] for r in recs)
    for r in recs:
        # the paper's check: Clueweb's replicated core fits one chip
        assert r["node_state_bytes_per_chip"] < 4.2e9
        assert r["collective_bytes_per_chip"]["all-gather"] == \
            get_config("semicore-webscale").n * 4


# ---------------------------------------------------------------- examples
@pytest.mark.parametrize("example,args", [
    ("torch_quickstart.py", ["--n", "20000", "--m", "150000"]),
    ("torch_dynamic_maintenance.py",
     ["--n", "5000", "--m", "30000", "--updates", "30"])])
def test_examples_run_on_the_cpu(example, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / example),
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "computations" in res.stdout
