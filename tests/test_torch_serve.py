"""LM serving on the port against the JAX package: parameters carried
across, the cache-free ``serve_prefill`` (through ``chunked_attention``),
``ServeEngine`` prefill, every ``serve_decode`` step, greedy ``generate``
and the caches (GQA's k, v and MLA's latent ckv, kr) for every LM id's
``reduced()`` config; ``chunked_attention`` over a grid of shapes; cache
and input specs and full-width parameter counts.

Tolerance 2e-4 on logits (float32 configs; the reference's own serving
test), 2e-5 on ``chunked_attention``.  The attention runs its plain
version here; the flash-decode kernels run on the card only
(``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.base import LMConfig as JLMConfig  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data.pipeline import TokenSource as JTokenSource  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.params import tree_init as jinit  # noqa: E402
from repro.models.params import tree_num_params as jnum  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.configs import LMConfig, get_config, shapes  # noqa: E402
from repro_torch.data import TokenSource  # noqa: E402
from repro_torch.interop import lm_params_from  # noqa: E402
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.params import tree_num_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
             vocab=97, d_head=8, qk_norm=True)
LM_IDS = ("qwen3-0.6b", "qwen3-14b", "yi-34b", "arctic-480b",
          "deepseek-v3-671b")
#: the serving tests' configs: the reference's serving test, then every LM
#: id's reduced() config ("qwen3-reduced" is qwen3-0.6b's)
WHICH = ["small", "qwen3-reduced", *(f"{a}-reduced" for a in LM_IDS[1:])]


def _configs(which):
    if which == "small":  # the reference's serving test
        return JLMConfig(**SMALL, dtype=jnp.float32), \
            LMConfig(**SMALL, dtype=torch.float32)
    arch = "qwen3-0.6b" if which == "qwen3-reduced" else \
        which[:-len("-reduced")]
    return jget(arch).reduced(), get_config(arch).reduced()


def _carried(which, seed=0):
    jcfg, cfg = _configs(which)
    jp = jinit(jtfm.lm_param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, lm_params_from(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")


def _prompts(vocab, B=2, S=5, step=0):
    return TokenSource(B, S, vocab, seed=1)(step)["tokens"]


@pytest.mark.parametrize("which", WHICH)
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
    assert sorted(eng.caches) == sorted(jeng.caches)
    for name in eng.caches:
        np.testing.assert_allclose(eng.caches[name].numpy(),
                                   np.asarray(jeng.caches[name]), **TOL)
    assert int(eng.caches["len"]) == int(jeng.caches["len"]) == 9
    assert eng.caches["len"].dtype == torch.int32


@pytest.mark.parametrize("which", WHICH)
def test_generate_matches_jax(which):
    jcfg, cfg, jp, pp = _carried(which, seed=3)
    prompts = _prompts(cfg.vocab, S=6, step=2)
    jeng = JServeEngine(jp, jcfg, batch_slots=2, max_len=32)
    eng = ServeEngine(pp, cfg, batch_slots=2, max_len=32, device="cpu")
    want = jeng.generate(prompts, steps=5)
    got = eng.generate(prompts, steps=5)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    for name in eng.caches:
        np.testing.assert_allclose(eng.caches[name].numpy(),
                                   np.asarray(jeng.caches[name]), **TOL)
    assert int(eng.caches["len"]) == int(jeng.caches["len"]) == 11


@pytest.mark.parametrize("S", [1, 9, 40])
@pytest.mark.parametrize("which", WHICH)
def test_serve_prefill_matches_jax(which, S):
    """The cache-free forward: ``serve_prefill``'s last-position logits
    and ``lm_forward``'s hidden states at every position."""
    jcfg, cfg, jp, pp = _carried(which, seed=5)
    prompts = _prompts(cfg.vocab, B=3, S=S, step=4)
    want = np.asarray(jtfm.serve_prefill(jp, jcfg, jnp.asarray(prompts)))
    got = tfm.serve_prefill(pp, cfg, torch.as_tensor(prompts))
    assert got.shape == (3, 1, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jh, jc = jtfm.lm_forward(jp, jcfg, jnp.asarray(prompts))
    h, c = tfm.lm_forward(pp, cfg, torch.as_tensor(prompts))
    assert c is None and jc is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("which", WHICH)
def test_decode_logits_match_the_cache_free_forward(which):
    """The engine's teacher-forced decode steps against the cache-free
    forward over the same tokens, position by position (MLA: the absorbed
    latent form against the decompressed one).  A decode step routes 2
    tokens (capacity 8: nothing drops); the cache-free side runs at a
    capacity factor that drops nothing either (C >= T)."""
    _, cfg, _, pp = _carried(which, seed=6)
    prompts = _prompts(cfg.vocab, B=2, S=12, step=5)
    eng = ServeEngine(pp, cfg, 2, 16, device="cpu")
    steps = [eng.decode(prompts[:, i:i + 1])[:, 0] for i in range(12)]
    full_cfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    hidden, _ = tfm.lm_forward(pp, full_cfg, torch.as_tensor(prompts))
    full = tfm.lm_logits(pp, cfg, hidden)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               **TOL)


#: (S, T, q_offset, kv_len) at chunk 16: a ragged T; queries at the end of
#: a longer sequence; an offset with a key limit; a limit inside the
#: diagonal; few queries against many chunks (most above the diagonal)
ATTN_SHAPES = [(40, 40, 0, None), (8, 48, 40, None), (20, 64, 10, 37),
               (33, 33, 0, 20), (5, 100, 0, None)]


def _attn_inputs(S, T, G, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    Hkv, B = 2, 2
    q = rng.normal(size=(B, S, Hkv * G, d)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(16, 16), (24, 16)])
@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("S,T,q_offset,kv_len", ATTN_SHAPES)
def test_chunked_attention_matches_jax(S, T, q_offset, kv_len, G, d, dv,
                                       causal):
    q, k, v = _attn_inputs(S, T, G, d, dv)
    kw = dict(chunk=16, causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = layers.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(v), **kw)
    assert got.shape == want.shape == (2, S, 2 * G, dv)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,q_offset,kv_len", ATTN_SHAPES)
def test_chunked_attention_skipping_equals_every_chunk(S, T, q_offset,
                                                       kv_len, causal,
                                                       monkeypatch):
    """Skipping the chunks and leading rows a chunk masks wholly changes
    nothing against running every chunk on every row, as the reference's
    scan does; and at least one case skips."""
    q, k, v = (torch.as_tensor(a) for a in _attn_inputs(S, T, 2, 16, 16, 3))
    kw = dict(chunk=16, causal=causal, q_offset=q_offset, kv_len=kv_len)
    skipped = layers.chunked_attention(q, k, v, **kw)
    monkeypatch.setattr(layers, "_live_rows",
                        lambda n, *a: [(ci, 0) for ci in range(n)])
    every = layers.chunked_attention(q, k, v, **kw)
    torch.testing.assert_close(skipped, every, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("args,want", [
    # (nchunks, chunk, S, causal, q_offset, valid_len)
    ((4, 16, 64, True, 0, 64), [(0, 0), (1, 16), (2, 32), (3, 48)]),
    ((7, 16, 5, True, 0, 100), [(0, 0)]),
    ((4, 16, 20, True, 10, 37), [(0, 0), (1, 6)]),
    ((4, 16, 20, False, 10, 37), [(0, 0), (1, 0), (2, 0)]),
    ((3, 16, 8, True, 40, 48), [(0, 0), (1, 0), (2, 0)]),
    # no key for some row: every chunk on every row, as the reference
    ((3, 16, 8, True, 0, 0), [(0, 0), (1, 0), (2, 0)]),
    ((3, 16, 8, True, -2, 48), [(0, 0), (1, 0), (2, 0)]),
])
def test_live_rows_skip_only_wholly_masked_work(args, want):
    assert layers._live_rows(*args) == want


def test_chunked_attention_keeps_bf16_and_scores_in_float32():
    """bfloat16 operands: the result in bfloat16, within one bfloat16 step
    of the float32 computation on the same (bf16-rounded) operands."""
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in _attn_inputs(24, 24, 2, 16, 16, 4))
    got = layers.chunked_attention(q, k, v, chunk=16)
    want = layers.chunked_attention(q.float(), k.float(), v.float(), chunk=16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=2 ** -7)


def test_token_source_matches_reference():
    for step in (0, 3):
        got = TokenSource(3, 9, 151936, seed=2)(step)
        want = JTokenSource(3, 9, 151936, seed=2)(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_qwen3_full_width_parameter_count():
    n = tree_num_params(tfm.lm_param_specs(get_config("qwen3-0.6b")))
    assert n == jnum(jtfm.lm_param_specs(jget("qwen3-0.6b"))) == 751_632_384


@pytest.mark.parametrize("arch", LM_IDS)
def test_full_width_parameter_count_matches_reference(arch):
    n = tree_num_params(tfm.lm_param_specs(get_config(arch)))
    assert n == jnum(jtfm.lm_param_specs(jget(arch)))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_IDS)
def test_param_specs_match_reference(arch, reduced):
    """Every leaf's name, shape, axes, dtype and init, MoE, MLA and MTP
    trees included."""
    jcfg, cfg = jget(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    from repro_torch.models.params import tree_leaves

    want = dict(tree_leaves(jtfm.lm_param_specs(jcfg)))
    got = dict(tree_leaves(tfm.lm_param_specs(cfg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.axes, g.init, g.scale) == \
            (w.shape, w.axes, w.init, w.scale), k
        assert str(g.dtype).split(".")[-1] == w.dtype.__name__, k
    assert tfm.layer_groups(cfg) == jtfm.layer_groups(jcfg)


@pytest.mark.parametrize("arch", LM_IDS)
def test_every_cache_spec_matches_reference(arch):
    """GQA's k, v and MLA's latent ckv, kr: shape and dtype, full width
    and reduced."""
    for jcfg, cfg in ((jget(arch), get_config(arch)),
                      (jget(arch).reduced(), get_config(arch).reduced())):
        want = jtfm.make_kv_cache_specs(jcfg, 3, 40)
        got = tfm.make_kv_cache_specs(cfg, 3, 40)
        assert list(got) == list(want)
        for k in want:
            assert got[k][0] == want[k].shape
            assert str(got[k][1]).split(".")[-1] == want[k].dtype.name
    if get_config(arch).mla is not None:
        assert list(got) == ["ckv", "kr", "len"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("shape", list(shapes.LM_SHAPES))
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_specs_match_reference(arch, shape, reduced):
    jcfg, cfg = jget(arch), get_config(arch)
    want = jshapes._lm_specs(jcfg, jshapes.LM_SHAPES[shape], reduced)
    got = shapes.lm_specs(cfg, shape, reduced)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "caches":
            assert sorted(got[k]) == sorted(w)
            for c in w:
                assert got[k][c][0] == w[c].shape
        else:
            assert got[k] == (w.shape, torch.int32)


def test_cache_specs_match_reference():
    jcfg, cfg = _configs("qwen3-reduced")
    want = jtfm.make_kv_cache_specs(jcfg, 3, 40)
    got = tfm.make_kv_cache_specs(cfg, 3, 40)
    for k in want:
        assert got[k][0] == want[k].shape


@pytest.mark.parametrize("what", ["lm_loss", "softmax_xent", "_mtp_loss"])
def test_lm_losses_match_jax(what):
    """The three training losses, ported (they raised before): each on
    DeepSeek-V3's reduced config (MTP depth 1) against the JAX package's,
    the loss within 1e-5 and the gradient of its first argument within
    1e-4 x max|want| + 1e-6."""
    jcfg, cfg, jp, pp = _carried("deepseek-v3-671b-reduced")
    batch = TokenSource(2, 16, cfg.vocab, seed=3)(0)
    tok, lab = batch["tokens"], batch["labels"]
    jhidden = np.asarray(jtfm.lm_forward(jp, jcfg, jnp.asarray(tok))[0])
    args = {"lm_loss": (jp, (jcfg, tok, lab)),
            "softmax_xent": (np.asarray(jtfm.lm_logits(jp, jcfg, jhidden)),
                             (lab,)),
            "_mtp_loss": (jp, (jcfg, jhidden, tok, lab))}[what]
    first, rest = args
    jfn = getattr(jtfm, what)
    want, jg = jax.value_and_grad(jfn)(
        jax.tree.map(jnp.asarray, first),
        *(a if isinstance(a, JLMConfig) else jnp.asarray(a) for a in rest))
    if what == "softmax_xent":
        x = torch.tensor(first, requires_grad=True)
        got = tfm.softmax_xent(x, torch.as_tensor(lab))
        grads, jflat = [x], [np.asarray(jg)]
    else:
        from repro_torch.models.params import tree_leaves, requires_grad

        leaves = requires_grad(pp)
        port_rest = [cfg] + [torch.tensor(np.asarray(a)) for a in rest[1:]]
        got = getattr(tfm, what)(pp, *port_rest)
        grads = leaves
        flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(jg)[0]}
        jflat = [flat["".join(f"[{p!r}]" for p in n.split("."))]
                 for n, _ in tree_leaves(pp)]
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    for t, w in zip(grads, jflat):
        g = np.zeros(t.shape, np.float32) if t.grad is None else \
            t.grad.numpy()
        assert np.abs(g - w).max(initial=0) <= 1e-4 * np.abs(w).max(
            initial=0) + 1e-6


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
