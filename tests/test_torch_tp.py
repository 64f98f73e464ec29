"""Megatron tensor parallelism for dense LM serving over a ``model`` axis
wider than 1, and ``long_500k``'s cache sequence split over every axis,
against the one-device step and the JAX package.

The port's ranks are gloo processes on the CPU (``torch_pg_ranks.tp_cases``,
which imports no JAX), started once per mesh layout ``(data, model)`` in
:data:`LAYOUTS` with every case in that one start.  Each case is one of
the dense GQA ids' ``reduced()`` configs (float32), ``prefill_32k`` or
three ``decode_32k`` steps from a seeded cache whose length ``len`` starts
at one of :func:`start_lengths`.  Every rank's logits (joined whole) and
cache pieces are held within 1e-5 of the one-device step cut by the
reference's placements, and the logits within 2e-4 of the reference's
bundle jitted with its shardings on forced host devices (the serving
tests' tolerance).  ``long_500k`` (batch 1) runs three decode steps on
:data:`LONG_LAYOUTS`, its sequence cut into D * M pieces, from each
:func:`long_lengths`; exactly one rank writes each step's k and v.  The
flash-decode partials of a sequence cut into
pieces are held to the whole cache's attention on their plain versions
(the kernels themselves are held to those on the card,
``tests/test_torch_cuda.py``).
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
from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.params import tree_init, tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
CPU = torch.device("cpu")
ARCHS = ("qwen3-0.6b", "qwen3-14b", "yi-34b")
LAYOUTS = ((1, 2), (1, 4), (2, 2))
#: long_500k's layouts: the sequence over every axis, with and without TP
LONG_LAYOUTS = ((1, 2), (2, 1), (2, 2))
DECODE_STEPS = 3
ONE_DEVICE_TOL = 1e-5
REFERENCE_TOL = 2e-4


def start_lengths(T: int, M: int) -> dict:
    """``len`` before the first of the three decode steps: 0; inside rank
    0's piece (every other piece empty); one below the first piece
    boundary (the steps write on both sides of it); and three below T
    (the last step writes position T - 1 and attends to all T)."""
    return {"zero": 0, "inside": 5, "boundary": T // M - 1,
            "last": T - DECODE_STEPS}


def long_lengths(T: int, P: int) -> dict:
    """``len`` before long_500k's first decode step, its sequence of T in P
    pieces: 0; inside piece 0; one below each piece boundary; T - 3."""
    out = {"zero": 0, "inside": 5}
    out.update({f"boundary{p}": p * T // P - 1 for p in range(1, P)})
    out["last"] = T - DECODE_STEPS
    return out


def _long_T() -> int:
    _, av = steps.build_step(ARCHS[0], "long_500k", reduced=True).args[1:]
    return av["k"][0][2]


RUN_LAYOUTS = LAYOUTS + tuple(lo for lo in LONG_LAYOUTS if lo not in LAYOUTS)
LONG_STARTS = [(layout, tag) for layout in LONG_LAYOUTS
               for tag in long_lengths(_long_T(), layout[0] * layout[1])]


def _layout_name(layout) -> str:
    return "x".join(map(str, layout))


def _cases(layout) -> dict:
    D, M = layout
    cases = {}
    if layout in LAYOUTS:
        _, av = steps.build_step(ARCHS[0], "decode_32k",
                                 reduced=True).args[1:]
        T = av["k"][0][2]
        for arch in ARCHS:
            cases[f"{arch}|prefill"] = {"arch": arch, "shape": "prefill_32k"}
            for tag, n in start_lengths(T, M).items():
                cases[f"{arch}|decode|{tag}"] = {"arch": arch,
                                                 "shape": "decode_32k",
                                                 "len": n}
    if layout in LONG_LAYOUTS:
        for tag, n in long_lengths(_long_T(), D * M).items():
            cases[f"{ARCHS[0]}|long|{tag}"] = {"arch": ARCHS[0],
                                               "shape": "long_500k",
                                               "len": n}
    return cases


def _inputs(arch: str, case: dict, seed: int) -> dict:
    """A case's global inputs, seeded with numpy."""
    cfg = get_config(arch).reduced()
    b = steps.build_step(arch, case["shape"], reduced=True)
    rng = np.random.default_rng(seed)
    if case["shape"] == "prefill_32k":
        (B, S), _ = b.args[1]
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    (B, _), _ = b.args[1]
    kv_shape = b.args[2]["k"][0]
    caches = {k: torch.as_tensor(rng.normal(size=kv_shape).astype(np.float32))
              for k in ("k", "v")}
    caches["len"] = torch.tensor(case["len"], dtype=torch.int32)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)) for _ in range(DECODE_STEPS)]
    return {"tokens": toks, "caches": caches}


_REFERENCE_TP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert len(jax.devices()) >= 4
from repro.launch.mesh import use_mesh
from repro.launch.steps import build_step

case_dir, out = sys.argv[1], sys.argv[2]
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

params = {}
for lname, (D, M) in layouts.items():
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    cases = json.load(open(f"{case_dir}/{lname}/cases.json"))
    fns = {}
    res = {}
    for name, case in cases.items():
        arch, shape = case["arch"], case["shape"]
        if arch not in params:
            with np.load(f"{case_dir}/{arch}.npz") as z:
                params[arch] = {k: z[k] for k in z.files}
        if (arch, shape) not in fns:
            b = build_step(arch, shape, mesh, reduced=True)
            fns[arch, shape] = jax.jit(b.fn, in_shardings=b.in_shardings,
                                       out_shardings=b.out_shardings)
        fn = fns[arch, shape]
        p = nest(params[arch])
        key = name.replace("|", "__")
        with np.load(f"{case_dir}/{lname}/{key}.npz") as z:
            with use_mesh(mesh):
                if shape == "prefill_32k":
                    res[f"{key}__0"] = np.asarray(fn(p, jnp.asarray(z["tokens"])))
                    continue
                caches = {"k": jnp.asarray(z["k"]), "v": jnp.asarray(z["v"]),
                          "len": jnp.int32(int(z["len"]))}
                for i in range(int(z["steps"])):
                    logits, caches = fn(p, jnp.asarray(z[f"tok{i}"]), caches)
                    res[f"{key}__{i}"] = np.asarray(logits)
    np.savez(f"{out}/{lname}.npz", **res)
print("REFERENCE_TP_OK")
"""


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The one-device steps, the ranks' runs (one start a layout) and the
    reference's sharded bundles (one subprocess on 4 forced host devices,
    run beside the ranks)."""
    case_dir = tmp_path_factory.mktemp("tp_cases")
    ref_dir = tmp_path_factory.mktemp("tp_reference")
    params = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        params[arch] = tree_init(tfm.lm_param_specs(cfg),
                                 torch.Generator().manual_seed(11 + i))
        torch.save(tree_map(lambda t: t.detach().clone(), params[arch]),
                   case_dir / f"{arch}.pt")
        np.savez(case_dir / f"{arch}.npz",
                 **{n: t.detach().numpy() for n, t in
                    tree_leaves(params[arch])})
    one = {}
    for layout in RUN_LAYOUTS:
        lname = _layout_name(layout)
        (case_dir / lname).mkdir()
        cases = _cases(layout)
        (case_dir / lname / "cases.json").write_text(json.dumps(cases))
        for seed, (name, case) in enumerate(cases.items()):
            x = _inputs(case["arch"], case, seed)
            torch.save(x, case_dir / lname / f"{name}.pt")
            key = name.replace("|", "__")
            if case["shape"] == "prefill_32k":
                np.savez(case_dir / lname / f"{key}.npz",
                         tokens=x["tokens"].numpy())
            else:
                np.savez(case_dir / lname / f"{key}.npz",
                         k=x["caches"]["k"].numpy(),
                         v=x["caches"]["v"].numpy(), len=case["len"],
                         steps=DECODE_STEPS,
                         **{f"tok{i}": t.numpy()
                            for i, t in enumerate(x["tokens"])})
            one[lname, name] = _one_device(params[case["arch"]], case, x)
    (case_dir / "layouts.json").write_text(json.dumps(
        {_layout_name(lo): lo for lo in RUN_LAYOUTS}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_TP, case_dir,
                            ref_dir], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    outs = {}
    try:
        for layout in RUN_LAYOUTS:
            lname = _layout_name(layout)
            out = tmp_path_factory.mktemp(f"tp_ranks_{lname}")
            run_ranks("torch_pg_ranks:tp_cases", layout[0] * layout[1],
                      backend="gloo",
                      args=[case_dir / lname, case_dir, out, *layout],
                      paths=[TESTS], timeout=600,
                      env={"OMP_NUM_THREADS": "1"})
            outs[lname] = out
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REFERENCE_TP_OK" in stdout, \
        stderr[-3000:]
    return {"one": one, "outs": outs, "ref": ref_dir, "case_dir": case_dir}


def _one_device(params, case, x):
    """The one-device step's logits (each step) and final caches."""
    b = steps.build_step(case["arch"], case["shape"], reduced=True)
    if case["shape"] == "prefill_32k":
        return {"logits": [b.fn(params, x["tokens"])]}
    caches = {k: v.clone() for k, v in x["caches"].items()}
    logits = []
    for tok in x["tokens"]:
        lg, caches = b.fn(params, tok, caches)
        logits.append(lg)
    return {"logits": logits, "caches": caches}


def _rank_records(runs, lname, name, layout):
    return [torch.load(runs["outs"][lname] / f"{name}_{r}.pt")
            for r in range(layout[0] * layout[1])]


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _hold_logits(runs, lname, name, layout, recs):
    """Every rank's joined logits against the one-device step and the
    reference, and its vocab piece (batch over data, but for long_500k's
    batch of 1) against the one-device step's."""
    one = runs["one"][lname, name]
    cfg = get_config(name.split("|")[0]).reduced()
    D, M = layout
    if "|long|" in name:
        D = 1
    key = name.replace("|", "__")
    with np.load(runs["ref"] / f"{lname}.npz") as z:
        for r, rec in enumerate(recs):
            assert len(rec["logits"]) == len(one["logits"])
            for i, (got, want) in enumerate(zip(rec["logits"],
                                                one["logits"])):
                assert got.shape == want.shape
                _close(got, want, ONE_DEVICE_TOL,
                       f"{lname} {name} rank {r} step {i} vs one device")
                _close(got, torch.as_tensor(z[f"{key}__{i}"]), REFERENCE_TOL,
                       f"{lname} {name} rank {r} step {i} vs the reference")
            pieces = rec.get("logits_pieces") or [rec["logits_piece"]]
            for i, piece in enumerate(pieces):
                B = one["logits"][i].shape[0]
                assert piece.shape == (B // D, 1, cfg.vocab // M)
                c = rec["coords"]
                row = c["data"] if D > 1 else 0
                want = one["logits"][i][
                    row * (B // D):(row + 1) * (B // D), :,
                    c["model"] * (cfg.vocab // M):
                    (c["model"] + 1) * (cfg.vocab // M)]
                _close(piece, want, ONE_DEVICE_TOL,
                       f"{lname} {name} rank {r} logits piece")


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_equals_one_device_and_the_reference(tp_runs, arch,
                                                        layout):
    lname, name = _layout_name(layout), f"{arch}|prefill"
    recs = _rank_records(tp_runs, lname, name, layout)
    _hold_logits(tp_runs, lname, name, layout, recs)


@pytest.mark.parametrize("start", ["zero", "inside", "boundary", "last"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_decode_equals_one_device_and_the_reference(tp_runs, arch, layout,
                                                       start):
    """Three decode steps: the joined logits of every step, and every
    rank's cache pieces (batch over data, sequence over model) after
    them, equal to the one-device step's cut by the placements."""
    lname, name = _layout_name(layout), f"{arch}|decode|{start}"
    recs = _rank_records(tp_runs, lname, name, layout)
    _hold_logits(tp_runs, lname, name, layout, recs)
    one = tp_runs["one"][lname, name]
    D, M = layout
    L, B, T = one["caches"]["k"].shape[:3]
    for r, rec in enumerate(recs):
        c = rec["coords"]
        for key in ("k", "v"):
            piece = rec["caches"][key]
            assert piece.shape == (L, B // D, T // M, *one["caches"][key]
                                   .shape[3:])
            want = one["caches"][key][
                :, c["data"] * (B // D):(c["data"] + 1) * (B // D),
                c["model"] * (T // M):(c["model"] + 1) * (T // M)]
            _close(piece, want, ONE_DEVICE_TOL,
                   f"{lname} {name} rank {r} cache {key}")
        assert int(rec["caches"]["len"]) == int(one["caches"]["len"]) == \
            start_lengths(T, M)[start] + DECODE_STEPS


@pytest.mark.parametrize("layout,start", LONG_STARTS,
                         ids=[f"{_layout_name(lo)}-{t}" for lo, t in
                              LONG_STARTS])
def test_long_500k_sequence_over_every_axis(tp_runs, layout, start):
    """Three long_500k decode steps, the cache sequence cut over all D * M
    ranks data-major: every rank's joined logits held as the decode
    cases' are, its sequence piece equal to the one-device step's cache
    cut at ``index * T / (D * M)``, and each step's k and v written on
    exactly one rank."""
    lname, name = _layout_name(layout), f"{ARCHS[0]}|long|{start}"
    recs = _rank_records(tp_runs, lname, name, layout)
    _hold_logits(tp_runs, lname, name, layout, recs)
    one = tp_runs["one"][lname, name]
    D, M = layout
    P = D * M
    L, B, T = one["caches"]["k"].shape[:3]
    assert B == 1
    for r, rec in enumerate(recs):
        c = rec["coords"]
        p = c["data"] * M + c["model"]
        for key in ("k", "v"):
            piece = rec["caches"][key]
            assert piece.shape == (L, B, T // P, *one["caches"][key]
                                   .shape[3:])
            want = one["caches"][key][:, :, p * (T // P):(p + 1) * (T // P)]
            _close(piece, want, ONE_DEVICE_TOL,
                   f"{lname} {name} rank {r} cache {key}")
        assert int(rec["caches"]["len"]) == \
            long_lengths(T, P)[start] + DECODE_STEPS
    for i in range(DECODE_STEPS):
        assert sum(rec["written"][i] for rec in recs) == 1, (name, i)


def test_long_500k_on_data_ranks_attends_the_whole_cache(tp_runs):
    """On a (2, 1) mesh (no tensor parallelism) each rank's logits are the
    whole cache's: far from the one-device step run on rank 0's piece
    alone, the answer a rank would give if it ignored the split."""
    layout = (2, 1)
    lname, name = _layout_name(layout), f"{ARCHS[0]}|long|last"
    recs = _rank_records(tp_runs, lname, name, layout)
    one = tp_runs["one"][lname, name]
    x = torch.load(tp_runs["case_dir"] / lname / f"{name}.pt")
    T = x["caches"]["k"].shape[2]
    piece = {k: x["caches"][k][:, :, :T // 2].clone() for k in ("k", "v")}
    piece["len"] = torch.tensor(T // 2 - 1, dtype=torch.int32)
    b = steps.build_step(ARCHS[0], "long_500k", reduced=True)
    params = torch.load(tp_runs["case_dir"] / f"{ARCHS[0]}.pt")
    alone, _ = b.fn(params, x["tokens"][0], piece)
    for rec in recs:
        _close(rec["logits"][0], one["logits"][0], ONE_DEVICE_TOL, "whole")
        err = float((rec["logits"][0] - alone).abs().max())
        assert err > 100 * ONE_DEVICE_TOL, err


@pytest.mark.parametrize("layout", LAYOUTS, ids=_layout_name)
def test_no_model_split_weight_is_gathered_whole(tp_runs, layout):
    """No all-gather in any case's steps takes a weight piece as its
    input; the same spy counts one such gather a split leaf when the
    weights are gathered as the one-rank path gathers them."""
    lname = _layout_name(layout)
    D, M = layout
    n_split = sum(1 for _, sh in tree_leaves(steps.build_step(
        ARCHS[0], "prefill_32k", Mesh(layout, ("data", "model")),
        reduced=True).in_shardings[0]) if sh.frac > 1)
    for name in _cases(layout):
        for r, rec in enumerate(_rank_records(tp_runs, lname, name, layout)):
            assert rec["gathers"] > 0, (name, r)
            assert rec["weight_gathers"] == 0, (name, r)
    for r in range(D * M):
        control = torch.load(tp_runs["outs"][lname] / f"control_{r}.pt")
        assert control["weight_gathers"] == control["gathers"] == n_split


# ------------------------------------------------------------ still raises
class _Group:
    """Stands in for a mesh's process group: every raise below comes
    before the step's first collective."""


def _mesh(shape):
    return Mesh(shape, ("data", "model"), [CPU], device_mesh=_Group())


RAISES = {
    "heads not divided": ("qwen3-14b", "prefill_32k", (1, 3),
                          "does not divide"),
}


@pytest.mark.parametrize("what", list(RAISES))
def test_what_tensor_parallelism_does_not_cover_still_raises(what):
    arch, shape, layout, words = RAISES[what]
    b = steps.build_step(arch, shape, _mesh(layout), reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8") \
            as exc:
        b.fn(*[None] * len(b.args))
    assert words in str(exc.value)


# ------------------------------------------- the pieces' plain partials
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("n", [-3, 0, 1, 5, 15, 16, 17, 63, 64, 70])
def test_pieces_merge_to_the_whole_caches_attention(P, n):
    """Each piece's ``split_plain`` at its offset, stacked and merged by
    ``combine_plain``, is the attention over the whole
    cache; a piece wholly past ``cache_len > 0`` is neutral (m = -inf,
    l = 0, acc = 0) and, for ``cache_len <= 0``, every piece covers its
    positions whole (the merge is the mean of V)."""
    rng = np.random.default_rng(P * 100 + n + 3)
    B, T, Hkv, G, d = 2, 64, 2, 3, 16
    q = torch.as_tensor(rng.normal(size=(B, Hkv * G, d)).astype(np.float32))
    k, v = (torch.as_tensor(rng.normal(size=(B, T, Hkv, d)).astype(
        np.float32)) for _ in range(2))
    lens = torch.tensor(n, dtype=torch.int32)
    Tp = T // P
    parts = [fdk.split_plain(q, k[:, p * Tp:(p + 1) * Tp],
                             v[:, p * Tp:(p + 1) * Tp], lens, p * Tp)
             for p in range(P)]
    for p, (ml, acc) in enumerate(parts):
        ns = fdk.piece_plan(n, p * Tp, Tp, B, Hkv, G)[2]
        if n > 0 and n <= p * Tp:
            assert ns == 0
            assert bool((ml[..., 0] == -torch.inf).all())
            assert bool((ml[..., 1] == 0).all()) and bool((acc == 0).all())
        else:
            assert ns >= 1
            covered = fdk.piece_plan(n, p * Tp, Tp, B, Hkv, G)[0]
            assert covered == (Tp if n <= 0 else min(n - p * Tp, Tp))
    ml = torch.stack([m for m, _ in parts])
    acc = torch.stack([a for _, a in parts])
    _close(fdk.combine_plain(ml, acc, lens, Tp, q.dtype),
           fdk.decode_attention_plain(q, k, v, lens), 2e-5, f"P={P} n={n}")
    # one piece at offset 0 is the whole cache's plan
    assert fdk.piece_plan(n, 0, T, B, Hkv, G) == fdk.split_plan(n, T, B, Hkv,
                                                                 G)


@pytest.mark.parametrize("heads,sliced", [
    ([0, 0, 1, 1], True), ([1, 1], True), ([2], True), ([0, 1, 2], True),
    ([0, 0, 0, 0, 1, 1], False), ([1, 1, 2, 2, 2, 2], False)])
def test_kv_heads_of_a_ranks_query_heads(heads, sliced):
    """The kv heads a rank's query heads attend: a slice of whole GQA
    groups where they form one (chunked attention's G = heads / kv),
    else one kv head a query head; either way query head j reads kv head
    ``heads[j]``."""
    k = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    v = -k
    ks, vs = tfm._kv_of_heads(k, v, heads)
    # a slice is a view of the caller's k, v; indexing copies
    assert (ks.untyped_storage().data_ptr()
            == k.untyped_storage().data_ptr()) == sliced
    G = len(heads) // ks.shape[2]
    for j, h in enumerate(heads):
        assert torch.equal(ks[:, :, j // G], k[:, :, h])
        assert torch.equal(vs[:, :, j // G], v[:, :, h])
