"""The GNN zoo on the port against the JAX package: GraphSAGE, GCN, SchNet
and EGNN in every mode of their shape cells (full graph, sampled
subgraph, molecule batch), forward outputs, ``gnn_loss`` and every
gradient leaf.

Inputs come from numpy (seeded) at the reduced cells' shapes, with
self-loops and edges into the sink row; weights come from the reference's
initialiser and are carried by ``repro_torch.interop.gnn_params_from``.
Tolerances: forward outputs and the loss within 1e-5 x max(1, max|want|);
every gradient leaf within 1e-4 x max|want| + 1e-6 (float32; the two sum
messages in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as JGNNConfig  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402

from repro_torch.configs import GNNConfig, get_config  # noqa: E402
from repro_torch.configs.shapes import GNN_SHAPES, input_specs  # noqa: E402
from repro_torch.interop import gnn_params_from  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

GNN_IDS = ("graphsage-reddit", "gcn-cora", "schnet", "egnn")
CELLS = [(a, s) for a in GNN_IDS for s in GNN_SHAPES]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _key(name: str) -> str:
    return "".join(f"[{part!r}]" for part in name.split("."))


def cell_inputs(cfg, shape: str, seed: int = 0) -> tuple:
    """``(batch, num_nodes)`` of the reduced cell as numpy arrays drawn
    from ``seed``: edges over every row, an eighth of them self-loops and
    another eighth into the sink row ``N - 1``; atomic numbers past the
    embedding table's 100 rows (clipped by both packages)."""
    _, av = input_specs(cfg, shape, reduced=True)
    N = av["num_nodes"]
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in av["batch"].items():
        if k in ("src", "dst"):
            out[k] = rng.integers(0, N, shp)
        elif k == "graph_ids":
            G = av["batch"]["y" if "y" in av["batch"] else "labels"][0][0]
            out[k] = np.repeat(np.arange(G), N // G)
        elif k == "labels":
            out[k] = rng.integers(0, cfg.num_classes, shp)
        elif k == "z":
            out[k] = rng.integers(0, 110, shp)
        else:
            out[k] = rng.normal(size=shp)
        out[k] = out[k].astype(np.int32 if dtype == torch.int32
                               else np.float32)
    E = len(out["src"])
    out["dst"][: E // 8] = out["src"][: E // 8]          # self-loops
    out["dst"][E // 8: E // 4] = N - 1                  # into the sink
    return out, N


def _weights(cfg, jcfg, batch, seed):
    d_in = batch["x"].shape[-1] if "x" in batch else 0
    jp = jinit(jgnn.gnn_param_specs(jcfg, d_in), jax.random.PRNGKey(seed))
    return jp, gnn_params_from(_np(jp), cfg, d_in, device="cpu")


def _close(got, want, what):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


def _forward(mod, arch, params, cfg, b, n):
    if arch == "schnet":
        return mod.schnet_forward(params, cfg, b["z"], b["pos"], b["src"],
                                  b["dst"], n)
    if arch == "egnn":
        return mod.egnn_forward(params, cfg, b["x"], b["pos"], b["src"],
                                b["dst"], n)
    fwd = mod.graphsage_forward if arch == "graphsage" else mod.gcn_forward
    return fwd(params, cfg, b["x"], b["src"], b["dst"], n)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_forward_and_loss_match_jax(arch, shape):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    batch, N = cell_inputs(cfg, shape, seed=1)
    jp, pp = _weights(cfg, jcfg, batch, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = _forward(jgnn, cfg.arch, jp, jcfg, jb, N)
    with torch.no_grad():
        got = _forward(gnn, cfg.arch, pp, cfg, tb, N)
    if cfg.arch == "egnn":  # (energies, positions)
        _close(got[1], want[1], f"{arch}/{shape} positions")
        got, want = got[0], want[0]
    assert tuple(got.shape) == want.shape
    _close(got, want, f"{arch}/{shape} forward")
    jl = jgnn.gnn_loss(jp, jcfg, {**jb, "num_nodes": N})
    with torch.no_grad():
        tl = gnn.gnn_loss(pp, cfg, {**tb, "num_nodes": N})
    _close(tl, jl, f"{arch}/{shape} loss")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_gradients_match_jax(arch, shape):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    batch, N = cell_inputs(cfg, shape, seed=3)
    jp, pp = _weights(cfg, jcfg, batch, seed=4)
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(
        jp, jcfg, {**{k: jnp.asarray(v) for k, v in batch.items()},
                   "num_nodes": N})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = steps.value_and_grad(
        lambda p, b: gnn.gnn_loss(p, cfg, {**b, "num_nodes": N}), pp, tb)
    _close(loss, jl, f"{arch}/{shape} loss")
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    names = [n for n, _ in tree_leaves(pp)]
    assert sorted(_key(n) for n in names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[_key(name)]
        lim = 1e-4 * float(np.abs(w).max(initial=0.0)) + 1e-6
        err = float(np.abs(g.numpy() - w).max(initial=0.0))
        assert err <= lim, (arch, shape, name, err, lim)
        assert np.isfinite(g.numpy()).all()


def test_param_specs_match_jax():
    for arch in GNN_IDS:
        for d_in in (0, 8, 1433):
            if arch != "schnet" and d_in == 0:
                continue
            for reduced in (False, True):
                jcfg, cfg = jget(arch), get_config(arch)
                if reduced:
                    jcfg, cfg = jcfg.reduced(), cfg.reduced()
                want = dict(jax.tree_util.tree_flatten_with_path(
                    jgnn.gnn_param_specs(jcfg, d_in),
                    is_leaf=lambda s: hasattr(s, "init"))[0])
                want = {jax.tree_util.keystr(k): v for k, v in want.items()}
                got = dict(tree_leaves(gnn.gnn_param_specs(cfg, d_in)))
                assert sorted(_key(n) for n in got) == sorted(want)
                for name, s in got.items():
                    w = want[_key(name)]
                    assert (s.shape, s.axes, s.init, s.scale) == \
                        (w.shape, w.axes, w.init, w.scale), (arch, name)


def test_schnet_self_loops_keep_finite_gradients():
    """SchNet's 1e-9 inside the norm: a graph of self-loops and edges
    into the sink (difference 0) gives finite gradients equal to JAX's."""
    jcfg, cfg = jget("schnet").reduced(), get_config("schnet").reduced()
    rng = np.random.default_rng(5)
    n = 9
    src = np.arange(n, dtype=np.int32)
    batch = {"src": np.concatenate([src, src]),
             "dst": np.concatenate([src, np.full(n, n - 1, np.int32)]),
             "z": rng.integers(1, 90, n).astype(np.int32),
             "pos": np.zeros((n, 3), np.float32),
             "y": rng.normal(size=n).astype(np.float32)}
    jp, pp = _weights(cfg, jcfg, batch, seed=6)
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(
        jp, jcfg, {**{k: jnp.asarray(v) for k, v in batch.items()},
                   "num_nodes": n})
    loss, grads = steps.value_and_grad(
        lambda p, b: gnn.gnn_loss(p, cfg, {**b, "num_nodes": n}), pp,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss, jl, "loss")
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    for (name, _), g in zip(tree_leaves(pp), grads):
        assert np.isfinite(g.numpy()).all(), name
        w = want[_key(name)]
        assert np.abs(g.numpy() - w).max(initial=0.0) <= \
            1e-4 * np.abs(w).max(initial=0.0) + 1e-6, name


def test_rbf_expand_matches_jax():
    dist = np.random.default_rng(7).uniform(0, 12, 50).astype(np.float32)
    want = jgnn._rbf_expand(jnp.asarray(dist), 300, 10.0)
    got = gnn._rbf_expand(torch.as_tensor(dist), 300, 10.0)
    _close(got, want, "rbf")


def test_segment_sum_saves_only_its_ids():
    """The aggregation keeps no (E, d) message tensor for its backward
    (only the ids), and its gradient is the output gradient gathered by
    the ids, as ``segment_sum``'s transpose."""
    saved = []
    vals = torch.randn(50, 7, requires_grad=True)
    idx = torch.as_tensor(np.random.default_rng(10).integers(0, 5, 50),
                          dtype=torch.int32)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = gnn._segsum(vals, idx, 5)
    assert saved == [(50,)]
    grad = torch.randn(5, 7)
    out.backward(grad)
    assert torch.equal(vals.grad, grad[idx.long()])
    want = jax.ops.segment_sum(jnp.asarray(vals.detach().numpy()),
                               jnp.asarray(idx.numpy()), num_segments=5)
    _close(out.detach(), want, "segment sum")


# ------------------------------------------- the reference's own GNN tests
def test_egnn_translation_invariance():
    """E(n): translating all coordinates leaves per-node energies unchanged
    (the port's copy of ``tests/test_models_extra.py``'s test)."""
    cfg = GNNConfig("e", arch="egnn", n_layers=2, d_hidden=16)
    jp = jinit(jgnn.egnn_param_specs(JGNNConfig("e", arch="egnn", n_layers=2,
                                                d_hidden=16), 8),
               jax.random.PRNGKey(0))
    params = gnn_params_from(_np(jp), cfg, 8, device="cpu")
    rng = np.random.default_rng(0)
    n, e = 12, 40
    x = torch.as_tensor(rng.normal(size=(n, 8)), dtype=torch.float32)
    pos = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    src = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    with torch.no_grad():
        e1, p1 = gnn.egnn_forward(params, cfg, x, pos, src, dst, n)
        e2, p2 = gnn.egnn_forward(params, cfg, x, pos + 5.0, src, dst, n)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)
    # and the positions move with the translation (equivariance)
    np.testing.assert_allclose(p2.numpy(), p1.numpy() + 5.0, rtol=1e-4,
                               atol=1e-4)


def test_gcn_isolated_nodes_finite():
    cfg = GNNConfig("g", arch="gcn", n_layers=2, d_hidden=8, num_classes=3)
    params = gnn_params_from(
        _np(jinit(jgnn.gcn_param_specs(JGNNConfig(
            "g", arch="gcn", n_layers=2, d_hidden=8, num_classes=3), 4),
            jax.random.PRNGKey(0))), cfg, 4, device="cpu")
    x = torch.ones((6, 4))
    src = torch.tensor([0, 1], dtype=torch.int32)
    dst = torch.tensor([1, 0], dtype=torch.int32)  # nodes 2..5 isolated
    with torch.no_grad():
        out = gnn.gcn_forward(params, cfg, x, src, dst, 6)
    assert torch.isfinite(out).all()


# --------------------------------------------- the out-of-range divergence
@pytest.mark.parametrize("arch", GNN_IDS)
@pytest.mark.parametrize("where", ["src", "dst"])
def test_out_of_range_ids_raise_where_the_reference_drops_them(arch, where):
    """An edge id past the node rows: the reference's ``segment_sum``
    drops an edge whose ``dst`` is out of range (its loss is the loss
    without that edge) and ``take`` fills an out-of-range ``src`` gather
    (NaN for floats); neither raises.  The port's ``index_select`` /
    ``index_add`` raise on the CPU (on the card they trip a device assert).
    No source makes such an id: padded edges point at the sink row."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    batch, N = cell_inputs(cfg, "molecule", seed=8)
    batch[where][0] = N
    jp, pp = _weights(cfg, jcfg, batch, seed=9)

    def jloss(b):
        return float(jgnn.gnn_loss(jp, jcfg, {
            **{k: jnp.asarray(v) for k, v in b.items()}, "num_nodes": N}))

    got = jloss(batch)
    if where == "dst":
        rest = {**batch, "src": batch["src"][1:], "dst": batch["dst"][1:]}
        assert np.isclose(got, jloss(rest), rtol=1e-6, atol=0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with pytest.raises((IndexError, RuntimeError)):
        gnn.gnn_loss(pp, cfg, {**tb, "num_nodes": N})
