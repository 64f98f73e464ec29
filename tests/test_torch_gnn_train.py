"""GNN training on the port against the JAX package: the configs and the
GNN cells' input specs, the neighbour sampler and the graph sources (byte
for byte the reference's arrays for the same sequence of calls), the GNN
train step of ``build_step`` and ``TrainLoop`` with checkpoints across
the two packages.

Tolerances: one AdamW step's parameters and moments within 1e-5 x
max(1, max|want|) of the reference's on the same weights and batch (a
moment ``v`` of a pooled energy's bias reaches ~50); a resumed ``TrainLoop``'s
losses within 1e-3 relative of the other package's continuing (four
steps of drift at lr 3e-3).
"""
import dataclasses
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.graph import chung_lu as jchung_lu  # noqa: E402
from repro.graph.sampler import NeighborSampler as JSampler  # noqa: E402
from repro.launch.mesh import make_host_mesh, use_mesh  # noqa: E402
from repro.launch.steps import build_step as jbuild_step  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.trainer import make_source as jmake_source  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import GNN_SHAPES, input_specs  # noqa: E402
from repro_torch.data import GNNFullGraphSource, SampledGraphSource  # noqa: E402
from repro_torch.graph import NeighborSampler, chung_lu  # noqa: E402
from repro_torch.interop import gnn_params_from, opt_state_from  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.params import tree_init, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import TrainLoop, checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import make_source  # noqa: E402

from test_torch_gnn import CELLS, GNN_IDS, cell_inputs  # noqa: E402

LR = 3e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _key(name: str) -> str:
    return "".join(f"[{part!r}]" for part in name.split("."))


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_batch(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert g.tobytes() == w.tobytes(), (what, k)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", GNN_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_gnn_configs_match_reference(arch, reduced):
    want, got = jregistry.get_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert type(got).__name__ == "GNNConfig"
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    assert str(w.pop("dtype").__name__) == str(g.pop("dtype")).split(".")[-1]
    assert w == g


@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_get_config_loads_every_arch_id(arch):
    assert ARCH_IDS == jregistry.ARCH_IDS
    cfg = get_config(arch)
    assert cfg.name == jregistry.get_config(arch).name
    assert cfg.kind == jregistry.get_config(arch).kind


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("reduced", [False, True])
def test_gnn_input_specs_match_reference(arch, shape, reduced):
    jcfg, cfg = jregistry.get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jkind, jav = jshapes.input_specs(jcfg, shape, reduced=reduced)
    kind, av = input_specs(cfg, shape, reduced=reduced)
    assert kind == jkind == "train"
    assert av["num_nodes"] == jav["num_nodes"]
    assert list(av["batch"]) == list(jav["batch"])
    for k, (shp, dtype) in av["batch"].items():
        w = jav["batch"][k]
        assert tuple(shp) == w.shape, (k, shp, w.shape)
        assert str(dtype).split(".")[-1] == str(w.dtype), k
    assert GNN_SHAPES[shape] == jshapes.GNN_SHAPES[shape]


# ------------------------------------------------------ sampler, sources
def _graphs(n=3000, m=9000):
    jg, g = jchung_lu(n, m, seed=1), chung_lu(n, m, seed=1)
    assert np.array_equal(jg.indptr, g.indptr)
    assert np.array_equal(jg.adj, g.adj)
    assert (np.diff(g.indptr) == 0).any()  # isolated seeds: self-loop pads
    return jg, g


def test_neighbor_sampler_matches_reference_call_for_call():
    jg, g = _graphs()
    js, ps = JSampler(jg, seed=3), NeighborSampler(g, seed=3)
    rng = np.random.default_rng(4)
    for call in range(6):
        seeds = rng.integers(0, g.n, 50 + call)
        if call % 2:
            want, got = js.sample_hop(seeds, 7), ps.sample_hop(seeds, 7)
            want, got = [want], [got]
        else:
            want = js.sample_batch(seeds, (5, 3))
            got = ps.sample_batch(seeds, (5, 3))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_batch({"seeds": a.seeds, "neighbors": a.neighbors,
                         "mask": np.ascontiguousarray(a.mask)},
                        {"seeds": b.seeds, "neighbors": b.neighbors,
                         "mask": np.ascontiguousarray(b.mask)},
                        f"call {call}")


def test_sampled_source_is_stateful_as_the_reference():
    """``SampledGraphSource(step)`` depends on the calls before it (its
    sampler's generator advances on every call), in both packages alike:
    the same sequence of calls gives the same batches, and asking for a
    step again gives another batch."""
    jg, g = _graphs()
    jsrc = jpipe.SampledGraphSource(jg, 8, 5, 16, (3, 2), seed=2)
    src = SampledGraphSource(g, 8, 5, 16, (3, 2), seed=2)
    calls = (0, 1, 0, 5, 1)
    got = [src(s) for s in calls]
    want = [jsrc(s) for s in calls]
    for s, a, b in zip(calls, got, want):
        _same_batch(a, b, f"step {s}")
    # step 0 twice: the same seeds, other neighbours
    assert np.array_equal(got[0]["labels"], got[2]["labels"])
    assert not np.array_equal(got[0]["x"], got[2]["x"])
    # a fresh source (a resumed loop) at step 1 differs from the second call
    fresh = SampledGraphSource(g, 8, 5, 16, (3, 2), seed=2)(1)
    _same_batch(fresh, jpipe.SampledGraphSource(jg, 8, 5, 16, (3, 2),
                                                seed=2)(1), "fresh")
    assert not np.array_equal(fresh["x"], got[1]["x"])


@pytest.mark.parametrize("arch", ["graphsage", "gcn", "schnet", "egnn"])
@pytest.mark.parametrize("core_order", [False, True])
@pytest.mark.parametrize("pad_nodes", [0, 1])
def test_full_graph_source_matches_reference(arch, core_order, pad_nodes):
    jg, g = _graphs(1500, 6000)
    want = jpipe.GNNFullGraphSource(jg, 6, 5, arch, seed=7,
                                    core_order=core_order,
                                    pad_nodes=pad_nodes)
    got = GNNFullGraphSource(g, 6, 5, arch, seed=7, core_order=core_order,
                             pad_nodes=pad_nodes)
    assert np.array_equal(got.graph.indptr, want.graph.indptr)
    assert np.array_equal(got.graph.adj, want.graph.adj)
    _same_batch(got(0), want(3), arch)
    assert got(0) is got(9)  # the same batch every step


_SOURCE_CELLS = ([(a, s, True) for a, s in CELLS]
                 + [(a, s, False) for a in GNN_IDS
                    for s in ("full_graph_sm", "molecule")])


@pytest.mark.parametrize("arch,shape,reduced", _SOURCE_CELLS)
def test_make_source_matches_reference(arch, shape, reduced):
    """Every GNN cell's source (reduced; the two small cells also at full
    size), three calls in a row, byte for byte."""
    jcfg, cfg = jregistry.get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jsrc, src = jmake_source(jcfg, shape, reduced), make_source(cfg, shape,
                                                               reduced)
    for step in range(3):
        _same_batch(src(step), jsrc(step), f"{arch}/{shape} step {step}")


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("arch,shape", CELLS)
def test_gnn_train_step_matches_jax(arch, shape):
    """One AdamW step of ``build_step``'s GNN train step on the same
    weights and batch: the loss, every parameter and both moments within
    1e-5 of the reference's."""
    mesh = make_host_mesh()
    jb = jbuild_step(arch, shape, mesh, reduced=True,
                     opt=jopt.AdamWConfig(lr=LR))
    b = steps.build_step(arch, shape, reduced=True, opt=AdamWConfig(lr=LR))
    assert b.name == jb.name == "train_step"
    assert b.num_params == jb.num_params
    jcfg, cfg = jb.static["cfg"], b.static["cfg"]
    batch, N = cell_inputs(cfg, shape, seed=11)
    assert b.static["num_nodes"] == N
    d_in = batch["x"].shape[-1] if "x" in batch else 0
    jp = jinit(jgnn.gnn_param_specs(jcfg, d_in), jax.random.PRNGKey(12))
    js = jopt.adamw_init(jp, jb.static["opt"])
    pp = gnn_params_from(_np(jp), cfg, d_in, device="cpu")
    ps = opt_state_from(_np(js), pp, device="cpu")
    with use_mesh(mesh):
        jp, js, jl = jax.jit(jb.fn)(jp, js, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    pp, ps, loss = b.fn(pp, ps, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    want = {**_jflat(jp), **{"['mu']" + k: v
                             for k, v in _jflat(js["mu"]).items()}}
    got = tree_leaves(pp) + [("mu." + n, t) for n, t in tree_leaves(ps["mu"])]
    assert sorted(_key(n) for n, _ in got) == sorted(want)
    for name, t in got:
        w = want[_key(name)]
        tol = 1e-5 * max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
    assert int(ps["step"]) == int(js["step"]) == 1


def test_gnn_step_builds_every_cell_at_full_width():
    """The full-width cells assemble without allocating: the reference's
    parameter counts and the specs' node counts."""
    for arch, shape in CELLS:
        b = steps.build_step(arch, shape)
        jb = jbuild_step(arch, shape, make_host_mesh())
        assert b.num_params == jb.num_params, (arch, shape)
        assert b.static["num_nodes"] == \
            jshapes.input_specs(jb.static["cfg"], shape)[1]["num_nodes"]
        assert not b.static["opt"].quantize_moments


# -------------------------------------------------------------- TrainLoop
def test_trainloop_gnn_descends_on_the_cpu():
    """The port's copy of ``tests/test_runtime.py``'s GNN loop: eight
    steps of gcn-cora's reduced full graph, finite, ending at most 1.5x
    the first loss."""
    r = TrainLoop("gcn-cora", reduced=True, log_every=0,
                  device="cpu").run(8, resume=False)
    assert len(r["losses"]) == 8 and np.isfinite(r["losses"]).all()
    assert r["losses"][-1] <= r["losses"][0] * 1.5


@pytest.mark.parametrize("first", ["jax", "port"])
def test_gnn_checkpoint_resumes_in_the_other_package(first, tmp_path):
    """gcn-cora's loop checkpoints at step 4 in one package; the other
    resumes it for 4 steps as the first's own loop continues."""
    loops = {"jax": lambda **kw: JTrainLoop("gcn-cora", reduced=True,
                                            log_every=0, **kw),
             "port": lambda **kw: TrainLoop("gcn-cora", reduced=True,
                                            log_every=0, device="cpu", **kw)}
    then = "port" if first == "jax" else "jax"
    d = tmp_path / "ckpt"
    loops[first](checkpoint_dir=str(d), checkpoint_every=1000).run(
        5, resume=False)
    assert jckpt.latest_step(str(d)) == ckpt.latest_step(str(d)) == 4
    shutil.copytree(d, tmp_path / "own")
    want = loops[first](checkpoint_dir=str(tmp_path / "own")).run(4)[
        "losses"]
    got = loops[then](checkpoint_dir=str(d)).run(4)["losses"]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert jckpt.latest_step(str(d)) == 8


@pytest.mark.parametrize("arch", ["schnet", "egnn"])
def test_regression_archs_fail_on_the_sampled_cell_as_the_reference(arch):
    """``SampledGraphSource`` gives no z / pos / y, so a regression arch's
    loop on ``minibatch_lg`` fails in both packages: the reference's at its
    jitted step, whose batch shardings name the cell's keys (ValueError),
    the port's at ``gnn_loss`` (KeyError for the first missing input)."""
    with pytest.raises(ValueError, match="pytree structure"):
        JTrainLoop(arch, shape="minibatch_lg", log_every=0).run(
            1, resume=False)
    loop = TrainLoop(arch, shape="minibatch_lg", log_every=0, device="cpu")
    with pytest.raises(KeyError, match="z" if arch == "schnet" else "pos"):
        loop.run(1, resume=False)
    b = make_source(loop.cfg, "minibatch_lg", True)(0)
    assert not {"z", "pos", "y"} & set(b)
    # the cell itself runs through the step on inputs made from its specs
    batch, _ = cell_inputs(loop.cfg, "minibatch_lg", seed=13)
    p = tree_init(loop.bundle.static["pspecs"],
                  torch.Generator().manual_seed(0))
    s = adamw_init(p, loop.bundle.static["opt"])
    _, _, loss = loop.fn(p, s, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    assert np.isfinite(float(loss))


def test_graphsage_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/torch_train_graphsage.py``: train, crash and resume."""
    monkeypatch.setattr(sys, "argv", ["torch_train_graphsage.py", "30",
                                      "--device", "cpu"])
    runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples"
                       / "torch_train_graphsage.py"), run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 25: loss ")
    assert out[1].startswith("trained 30 steps on cpu: loss ")
    assert out[2].startswith("resumed +20 steps: final loss ")
