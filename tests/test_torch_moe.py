"""The MoE layer on the port against the JAX package: ``moe_apply`` on
DeepSeek- and Arctic-shaped reduced configs, at capacities that drop and
with a router that sends every token to the same experts (where the
stable sort decides which tokens drop), the dense no-drop check of the
reference's own test, the Switch load-balance term and the capacity rule.

Tolerance 2e-5 (float32; the expert products and the scatter-add sum in
another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LMConfig as JLMConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402

from repro_torch.configs import LMConfig, MoEConfig, get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("deepseek-v3-671b", "arctic-480b")


def _configs(arch, capacity_factor=None):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _layer(jcfg, seed=0, skew=False):
    """Layer 0 of the reference's MoE parameters: (jax tree, torch tree).
    ``skew`` adds a large column to the router for experts 0 .. k-1, so
    every token takes the same experts."""
    jp = jax.tree.map(lambda a: a[0], jinit(jmoe.moe_param_specs(jcfg, 1),
                                            jax.random.PRNGKey(seed)))
    if skew:
        r = np.array(jp["router"])
        r[:, :jcfg.moe.top_k] += np.linspace(4.0, 2.0, jcfg.moe.top_k)
        jp["router"] = jnp.asarray(r)
    return jp, _to_torch(jp)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _x(shape, seed=2):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dropped(p, cfg, x):
    """(token, expert) assignments over capacity: the routing recomputed
    in numpy from the port's router, counted per expert."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    top_e = torch.topk(torch.softmax(torch.as_tensor(xt) @ p["router"], -1),
                       m.top_k).indices.numpy()
    counts = np.bincount(top_e.reshape(-1), minlength=m.num_experts)
    return int(np.maximum(counts - moe.moe_capacity(m, xt.shape[0]), 0).sum())


@pytest.mark.parametrize("shape", [(2, 64), (3, 17)])
@pytest.mark.parametrize("cf", [None, 0.5], ids=["published_cf", "cf0.5"])
@pytest.mark.parametrize("skew", [False, True], ids=["random", "skewed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, skew, cf, shape):
    jcfg, cfg = _configs(arch, cf)
    jp, p = _layer(jcfg, skew=skew)
    x = _x((*shape, cfg.d_model))
    want = np.asarray(jmoe.moe_apply(jp, jcfg, jnp.asarray(x)))
    got = moe.moe_apply(p, cfg, torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a capacity below T drops, and so do Arctic's skewed tokens (every
    # one to the same two of 8 experts); DeepSeek's reduced config routes
    # every token to all 8 experts, at capacity >= T
    if cf is not None or (skew and arch == "arctic-480b"):
        assert _dropped(p, cfg, x) > 0


@pytest.mark.parametrize("cf", [None, 0.5], ids=["published_cf", "cf0.5"])
@pytest.mark.parametrize("skew", [False, True], ids=["random", "skewed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_counts_the_dropped_assignments(arch, skew, cf):
    """``aux["dropped"]``: the (token, expert) assignments past each
    expert's capacity, the count recomputed from the router."""
    _, cfg = _configs(arch, cf)
    _, p = _layer(_configs(arch, cf)[0], skew=skew)
    x = _x((2, 64, cfg.d_model))
    aux = {}
    moe.moe_apply(p, cfg, torch.as_tensor(x), aux=aux)
    assert aux["dropped"].dtype == torch.int64
    assert int(aux["dropped"]) == _dropped(p, cfg, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_load_balance_matches_jax(arch):
    jcfg, cfg = _configs(arch, 0.5)
    jp, p = _layer(jcfg, seed=4)
    x = _x((2, 33, cfg.d_model), seed=5)
    jaux, aux = {}, {}
    jmoe.moe_apply(jp, jcfg, jnp.asarray(x), aux=jaux)
    moe.moe_apply(p, cfg, torch.as_tensor(x), aux=aux)
    assert aux["load_balance"].dtype == torch.float32
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(jaux["load_balance"]), **TOL)


def _dense_moe_reference(p, cfg, x):
    """Per-token loop over selected experts — no capacity, no dropping
    (the reference's own test, tests/test_models_extra.py)."""
    m = cfg.moe
    B, S, E = x.shape
    xt = np.asarray(x.reshape(-1, E), np.float32)
    logits = xt @ np.asarray(p["router"], np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    topk = np.argsort(-probs, axis=-1)[:, : m.top_k]
    out = np.zeros_like(xt)
    wg, wu, wd = (np.asarray(p["w_gate"]), np.asarray(p["w_up"]),
                  np.asarray(p["w_down"]))
    for t in range(xt.shape[0]):
        ps = probs[t, topk[t]]
        ps = ps / ps.sum()
        for e, g in zip(topk[t], ps):
            h = xt[t] @ wg[e]
            h = (h / (1 + np.exp(-h))) * (xt[t] @ wu[e])
            out[t] += g * (h @ wd[e])
    return out.reshape(B, S, E)


def test_moe_dispatch_matches_dense_reference_when_no_drops():
    fields = dict(n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32,
                  vocab=64)
    moe_f = dict(num_experts=4, top_k=2, d_ff_expert=8, capacity_factor=8.0)
    jcfg = JLMConfig("t", **fields, dtype=jnp.float32, moe=JMoEConfig(**moe_f))
    cfg = LMConfig("t", **fields, dtype=torch.float32, moe=MoEConfig(**moe_f))
    jp = jax.tree.map(lambda a: a[0], jinit(jmoe.moe_param_specs(jcfg, 1),
                                            jax.random.PRNGKey(1)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 6, 16)))
    got = moe.moe_apply(_to_torch(jp), cfg, torch.as_tensor(x))
    want = _dense_moe_reference({k: np.asarray(v) for k, v in jp.items()},
                                cfg, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [1, 7, 64, 100, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_rule_matches_reference(arch, T):
    """C = max(8, int(T * k / X * cf)), Python floats; the reference's
    dispatch buffer has C slots an expert."""
    jcfg, cfg = jget(arch), get_config(arch)
    m = jcfg.moe
    want = max(8, int(T * m.top_k / m.num_experts * m.capacity_factor))
    assert moe.moe_capacity(cfg.moe, T) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_specs_match_reference(arch):
    for jcfg, cfg in ((jget(arch), get_config(arch)),
                      (jget(arch).reduced(), get_config(arch).reduced())):
        want = jmoe.moe_param_specs(jcfg, 3)
        got = moe.moe_param_specs(cfg, 3)

        def flat(tree, prefix=""):
            for k in sorted(tree):
                v = tree[k]
                if isinstance(v, dict):
                    yield from flat(v, f"{prefix}{k}.")
                else:
                    yield f"{prefix}{k}", v

        w, g = dict(flat(want)), dict(flat(got))
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].axes == w[k].axes
            assert str(g[k].dtype).split(".")[-1] == w[k].dtype.__name__
