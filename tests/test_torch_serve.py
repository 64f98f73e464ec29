"""LM decode serving on the port against the JAX package: parameters
carried across, ``ServeEngine`` prefill, every ``serve_decode`` step,
greedy ``generate`` and the caches.

Tolerance 2e-4 on logits (float32 configs; the reference's own serving
test).  The attention runs its plain version here; the flash-decode
kernels run on the card only (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LMConfig as JLMConfig  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data.pipeline import TokenSource as JTokenSource  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402
from repro.models.params import tree_num_params as jnum  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.configs import LMConfig, MLAConfig, MoEConfig, get_config  # noqa: E402
from repro_torch.data import TokenSource  # noqa: E402
from repro_torch.interop import lm_params_from  # noqa: E402
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.params import tree_num_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
             vocab=97, d_head=8, qk_norm=True)


def _configs(which):
    if which == "small":  # the reference's serving test
        return JLMConfig(**SMALL, dtype=jnp.float32), \
            LMConfig(**SMALL, dtype=torch.float32)
    return jget("qwen3-0.6b").reduced(), get_config("qwen3-0.6b").reduced()


def _carried(which, seed=0):
    jcfg, cfg = _configs(which)
    jp = jinit(jtfm.lm_param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, lm_params_from(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")


def _prompts(vocab, B=2, S=5, step=0):
    return TokenSource(B, S, vocab, seed=1)(step)["tokens"]


@pytest.mark.parametrize("which", ["small", "qwen3-reduced"])
def test_prefill_and_every_decode_step_match_jax(which):
    jcfg, cfg, jp, pp = _carried(which)
    prompts = _prompts(cfg.vocab)
    jeng = JServeEngine(jp, jcfg, batch_slots=2, max_len=32)
    eng = ServeEngine(pp, cfg, batch_slots=2, max_len=32, device="cpu")
    np.testing.assert_allclose(eng.prefill(prompts).numpy(),
                               np.asarray(jeng.prefill(prompts)), **TOL)
    # further decode steps through the reference's serve_decode
    step = jax.jit(lambda p, t, c: jtfm.serve_decode(p, jcfg, t, c))
    tok = np.array([[3], [11]], np.int32)
    for _ in range(4):
        jl, jeng.caches = step(jp, jnp.asarray(tok), jeng.caches)
        got = eng.decode(tok)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(eng.caches[name].numpy(),
                                   np.asarray(jeng.caches[name]), **TOL)
    assert int(eng.caches["len"]) == int(jeng.caches["len"]) == 9
    assert eng.caches["len"].dtype == torch.int32


@pytest.mark.parametrize("which", ["small", "qwen3-reduced"])
def test_generate_matches_jax(which):
    jcfg, cfg, jp, pp = _carried(which, seed=3)
    prompts = _prompts(cfg.vocab, S=6, step=2)
    jeng = JServeEngine(jp, jcfg, batch_slots=2, max_len=32)
    eng = ServeEngine(pp, cfg, batch_slots=2, max_len=32, device="cpu")
    want = jeng.generate(prompts, steps=5)
    got = eng.generate(prompts, steps=5)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    for name in ("k", "v"):
        np.testing.assert_allclose(eng.caches[name].numpy(),
                                   np.asarray(jeng.caches[name]), **TOL)
    assert int(eng.caches["len"]) == int(jeng.caches["len"]) == 11


def test_token_source_matches_reference():
    for step in (0, 3):
        got = TokenSource(3, 9, 151936, seed=2)(step)
        want = JTokenSource(3, 9, 151936, seed=2)(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_qwen3_full_width_parameter_count():
    n = tree_num_params(tfm.lm_param_specs(get_config("qwen3-0.6b")))
    assert n == jnum(jtfm.lm_param_specs(jget("qwen3-0.6b"))) == 751_632_384


def test_cache_specs_match_reference():
    jcfg, cfg = _configs("qwen3-reduced")
    want = jtfm.make_kv_cache_specs(jcfg, 3, 40)
    got = tfm.make_kv_cache_specs(cfg, 3, 40)
    for k in want:
        assert got[k][0] == want[k].shape


@pytest.mark.parametrize("extra,what", [
    (dict(mla=MLAConfig()), "MLA"),
    (dict(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)), "MoE"),
    (dict(mtp_depth=1), "multi-token"),
])
def test_unported_lm_variants_raise(extra, what):
    cfg = LMConfig(**SMALL, dtype=torch.float32, **extra)
    with pytest.raises(NotImplementedError, match=f"{what}.*not ported yet"):
        tfm.lm_param_specs(cfg)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tfm.make_kv_cache_specs(cfg, 1, 8)


def test_forward_without_caches_is_not_ported():
    _, cfg, _, pp = _carried("small")
    with pytest.raises(NotImplementedError, match="chunked_attention"):
        tfm.lm_forward(pp, cfg, torch.zeros(1, 3, dtype=torch.int32))


def test_engine_device_and_cache_bounds(monkeypatch):
    _, cfg, _, pp = _carried("small")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(pp, cfg, batch_slots=2, max_len=8)
    eng = ServeEngine(pp, cfg, batch_slots=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        eng.prefill(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="outgrow"):
        eng.generate(np.zeros((2, 5), np.int32), steps=4)
    eng.prefill(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="outgrow"):
        eng.decode(np.zeros((2, 1), np.int32))
    assert int(eng.caches["len"]) == 8


def test_plain_attention_engine_equals_default_on_cpu(monkeypatch):
    _, cfg, _, pp = _carried("qwen3-reduced")
    prompts = _prompts(cfg.vocab)
    a = ServeEngine(pp, cfg, 2, 16, device="cpu").generate(prompts, 3)
    monkeypatch.setattr(fdk, "decode_attention", fdk.decode_attention_plain)
    b = ServeEngine(pp, cfg, 2, 16, device="cpu").generate(prompts, 3)
    np.testing.assert_array_equal(a, b)
