"""MIND serving on the port against the JAX package: configs, shapes, the
synthetic source, parameters carried across, ``mind_serve`` and
``mind_retrieval``.

Tolerance rtol 1e-4 / atol 1e-5 (float32; the bags and the routing sum in
another order).  The JAX side runs the bags through its Pallas kernel in
interpret mode as well as its plain path.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data.pipeline import RecsysSource as JRecsysSource  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402
from repro.models.params import tree_num_params as jnum  # noqa: E402

from repro_torch.configs import get_config, shapes  # noqa: E402
from repro_torch.data import RecsysSource  # noqa: E402
from repro_torch.interop import mind_params_from, params_from  # noqa: E402
from repro_torch.kernels import embedding_bag as ebk  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.models.params import tree_num_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def carried():
    jcfg = jget("mind").reduced()
    cfg = get_config("mind").reduced()
    jp = jinit(jrec.mind_param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jp, mind_params_from(jax.tree.map(np.asarray, jp), cfg,
                                           device="cpu")


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["mind", "qwen3-0.6b", "qwen3-14b", "yi-34b",
                                  "arctic-480b", "deepseek-v3-671b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    want, got = jget(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    assert str(w.pop("dtype").__name__) == str(g.pop("dtype")).split(".")[-1]
    assert w == g


def test_registry_refuses_what_is_not_ported():
    """Every id of the reference's registry loads; an unknown id raises."""
    assert get_config("graphsage-reddit").name == "graphsage-reddit"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-9")


@pytest.mark.parametrize("shape", list(shapes.RECSYS_SHAPES))
@pytest.mark.parametrize("reduced", [False, True])
def test_recsys_specs_match_reference(shape, reduced):
    cfg = get_config("mind")
    want = jshapes._recsys_specs(jget("mind"), jshapes.RECSYS_SHAPES[shape],
                                 reduced)
    got = shapes.recsys_specs(cfg, shape, reduced)
    assert sorted(got) == sorted(want)
    for k, (shp, dtype) in got.items():
        assert shp == want[k].shape and dtype == torch.int32
    assert shapes.RECSYS_SHAPES == jshapes.RECSYS_SHAPES
    assert shapes.LM_SHAPES == jshapes.LM_SHAPES


@pytest.mark.parametrize("step", [0, 1, 7])
def test_recsys_source_matches_reference(step):
    for cfg, jcfg in ((get_config("mind"), jget("mind")),
                      (get_config("mind").reduced(), jget("mind").reduced())):
        got = RecsysSource(cfg, 5, seed=3)(step)
        want = JRecsysSource(jcfg, 5, seed=3)(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_param_count_and_init():
    cfg = get_config("mind")
    assert tree_num_params(rec.mind_param_specs(cfg)) == \
        jnum(jrec.mind_param_specs(jget("mind")))
    small = cfg.reduced()
    a = rec.mind_init(small, torch.Generator().manual_seed(1))
    b = rec.mind_init(small, torch.Generator().manual_seed(1))
    assert a.keys() == ["bilinear", "item_embed", "mlp", "profile_embed",
                        "profile_proj"]
    assert torch.equal(a["item_embed"], b["item_embed"])
    assert a["item_embed"].shape == (small.n_items, small.embed_dim)
    assert (a["mlp"]["b1"] == 0).all()
    assert abs(float(a["item_embed"].std()) - 0.1) < 0.01


@pytest.mark.parametrize("step", [0, 1])
def test_mind_serve_matches_jax(carried, step, monkeypatch):
    jcfg, cfg, jp, pp = carried
    batch = RecsysSource(cfg, 6, seed=2)(step)
    want = np.asarray(jrec.mind_serve(jp, jcfg, _jax(batch)))
    kernel = np.asarray(jrec.user_interests(
        jp, jcfg, jnp.asarray(batch["hist_ids"]),
        jnp.asarray(batch["profile_ids"]), use_pallas_bag=True))
    np.testing.assert_array_equal(kernel, want)  # interpret == plain path
    got = rec.serve_step(pp, cfg, batch)
    assert got.shape == (6, cfg.n_interests, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
    monkeypatch.setattr(ebk, "embedding_bag", ebk.embedding_bag_plain)
    plain = rec.serve_step(pp, cfg, batch)
    assert torch.equal(plain, got)  # on the CPU both are the plain bag


@pytest.mark.parametrize("key,rows", [("hist_ids", "n_items"),
                                      ("profile_ids", "profile_vocab"),
                                      ("candidate_ids", "n_items")])
def test_steps_refuse_host_ids_past_their_table(carried, key, rows):
    _, cfg, _, pp = carried
    batch = RecsysSource(cfg, 2, seed=5)(0)
    batch["candidate_ids"] = np.arange(8, dtype=np.int32)
    rec.retrieval_step(pp, cfg, batch, top_k=4)
    batch[key] = batch[key].copy()
    batch[key].flat[-1] = getattr(cfg, rows)
    with pytest.raises(IndexError, match=f"{key}: .* {getattr(cfg, rows)} rows"):
        rec.serve_step(pp, cfg, batch)
    with pytest.raises(IndexError, match=key):
        rec.retrieval_step(pp, cfg, {**batch, key: torch.as_tensor(batch[key])})


def test_mind_retrieval_matches_jax(carried):
    jcfg, cfg, jp, pp = carried
    batch = RecsysSource(cfg, 1, seed=4)(0)
    batch["candidate_ids"] = np.random.default_rng(0).permutation(
        cfg.n_items)[:64].astype(np.int32)
    jv, ji = jrec.mind_retrieval(jp, jcfg, _jax(batch), top_k=10)
    v, i = rec.retrieval_step(pp, cfg, batch, top_k=10)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    v, _ = rec.retrieval_step(pp, cfg, batch)  # top 100 of 64 candidates
    assert v.shape == (1, 64)


def test_label_aware_attention_matches_jax():
    rng = np.random.default_rng(0)
    caps = rng.normal(size=(3, 4, 8)).astype(np.float32)
    tgt = rng.normal(size=(3, 8)).astype(np.float32)
    want = np.asarray(jrec.label_aware_attention(jnp.asarray(caps),
                                                 jnp.asarray(tgt)))
    got = rec.label_aware_attention(torch.as_tensor(caps),
                                    torch.as_tensor(tgt))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_params_from_refuses_missing_extra_and_misshapen_leaves(carried):
    _, cfg, jp, _ = carried
    arrays = jax.tree.map(np.asarray, jp)
    specs = rec.mind_param_specs(cfg)
    missing = {k: v for k, v in arrays.items() if k != "bilinear"}
    with pytest.raises(ValueError, match=r"missing leaves \['bilinear'\]"):
        params_from(missing, specs, device="cpu")
    extra = {**arrays, "mlp": {**arrays["mlp"], "b3": arrays["mlp"]["b2"]}}
    with pytest.raises(ValueError, match=r"mlp: .*extra leaves \['b3'\]"):
        params_from(extra, specs, device="cpu")
    bad = {**arrays, "bilinear": arrays["bilinear"][:, :3]}
    with pytest.raises(ValueError, match="bilinear: shape"):
        params_from(bad, specs, device="cpu")
    carried_tree = params_from(arrays, specs, device="cpu")
    for name in ("item_embed", "profile_proj"):
        np.testing.assert_array_equal(carried_tree[name].numpy(),
                                      arrays[name])


@pytest.mark.parametrize("carry", [params_from, mind_params_from])
def test_carried_weights_default_to_the_card(carried, carry, monkeypatch):
    """Without a device the weights go to cuda:0; with no GPU that raises
    and names the explicit host device, rather than landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, jp, _ = carried
    arrays = jax.tree.map(np.asarray, jp)
    what = rec.mind_param_specs(cfg) if carry is params_from else cfg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carry(arrays, what)
