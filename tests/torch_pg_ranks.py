"""Rank functions of the port's process-group tests (imports no JAX).

Each runs on every rank of a gloo group started by
``repro_torch.launch.ranks.run_ranks`` on the CPU, loops over its cases
and writes what it computed under the output directory it is given, as
``.npz`` files named by case and rank, for the test process to hold to
the one-process port and to the reference.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")
SHARD_FAMILIES = ("powerlaw", "isolated")
SHARD_ALGORITHMS = ("semicore", "semicore+", "semicore*")
RESULT_FIELDS = ("iterations", "node_computations", "edge_block_reads",
                 "node_table_reads", "updates_per_iter",
                 "computations_per_iter", "num_shards", "shard_pad_edges")


def warm_updates(g) -> tuple:
    """The warm cases' updates of ``g`` (either package's CSRGraph): a
    few seeded deletes and up to two new edges, as lists of pairs."""
    rng = np.random.default_rng(7)
    e = g.edge_list()
    dels = [(int(u), int(v))
            for u, v in e[rng.choice(len(e), min(5, len(e)), replace=False)]]
    ins = [(u, v) for u, v in ((0, g.n - 1), (1, g.n // 2))
           if u != v and not g.has_edge(u, v)]
    return dels, ins


def warm_graph(g):
    """``g`` with :func:`warm_updates` buffered, and the inserts' count."""
    from repro_torch.graph import BufferedGraph

    dels, ins = warm_updates(g)
    bg = BufferedGraph(g)
    for u, v in dels:
        bg.delete_edge(u, v)
    for u, v in ins:
        bg.insert_edge(u, v)
    return bg, len(ins)


def result_record(r) -> dict:
    rec = {"core": np.asarray(r.core, dtype=np.int64),
           "cnt": (np.zeros(0, np.int64) if r.cnt is None
                   else np.asarray(r.cnt, dtype=np.int64)),
           "has_cnt": np.asarray(r.cnt is not None)}
    for f in RESULT_FIELDS:
        rec[f] = np.asarray(getattr(r, f), dtype=np.int64)
    return rec


def shard_cases(out_dir: str) -> None:
    """The shard backend over the group: every family x algorithm cold,
    the warm settle of :func:`warm_graph`, ``distributed_decompose`` on a
    mesh, and one superstep of the core-graph cell's chunk function."""
    from repro_torch.core import (HostEngine, ShardedBackend, decompose,
                                  warm_settle)
    from repro_torch.core.distributed import distributed_decompose
    from repro_torch.graph.differential_cases import FAMILIES
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    rank = dist.get_rank()
    group = dist.group.WORLD
    for family in SHARD_FAMILIES:
        g = FAMILIES[family]()
        for algo in SHARD_ALGORITHMS:
            be = ShardedBackend(group=group, device=CPU)
            r = decompose(g, algo, "batch", block_edges=64, backend=be)
            np.savez(os.path.join(out_dir, f"{family}_{algo}_{rank}.npz"),
                     **result_record(r))
            if algo == "semicore*":
                bg, added = warm_graph(g)
                w = warm_settle(HostEngine(bg, block_edges=64), r.core,
                                added, ShardedBackend(group=group,
                                                      device=CPU))
                np.savez(os.path.join(out_dir, f"{family}_warm_{rank}.npz"),
                         **result_record(w))
    # distributed_decompose over the mesh of the group, cold and warm
    g = FAMILIES["powerlaw"]()
    mesh = make_host_mesh(max_data=None, device=CPU)
    core, iters = distributed_decompose(g, mesh=mesh)
    wcore, witers = distributed_decompose(
        g, mesh=mesh, core0=np.minimum(core + 2, g.degrees()))
    np.savez(os.path.join(out_dir, f"dd_{rank}.npz"), core=core,
             iters=np.asarray(iters), wcore=wcore, witers=np.asarray(witers))
    # the core-graph cell: one superstep of its chunk function
    from repro_torch.launch.steps import build_step

    b = build_step("semicore-webscale", "decompose", mesh, reduced=True)
    ss = b.fn.backend.bind_resident(HostEngine(g).planner)
    deg = torch.as_tensor(g.degrees().astype(np.int32))
    core0 = {CPU: deg.clone()}
    cnt = [torch.zeros(g.n, dtype=torch.int32) for _ in ss.shards]
    active = [t.owned & (deg > 0) for t in ss.shards]
    nact = b.fn.backend.count_active(ss, active)
    core1, cnt1, _, nact1, _, upds, ran = b.fn(ss, core0, cnt, active, nact)
    np.savez(os.path.join(out_dir, f"cell_{rank}.npz"),
             core=core1[CPU].numpy(), upd=upds[0].numpy(),
             nact=nact1.numpy(), ran=ran[0].numpy())


def train_cases(case_dir: str, out_dir: str) -> None:
    """One data-parallel train step a case over the group: each case's
    global params, state and batch (``case.pt`` files written by the
    test) cut to this rank's pieces, the step run, its outputs joined
    whole; rank 0 writes them, and every rank what :class:`_MomentSpy`
    saw (``<case>_moments_<rank>.pt``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_step, gather_outputs,
                                          local_args)
    from repro_torch.optim import AdamWConfig

    torch.set_num_threads(1)
    mesh = make_host_mesh(max_data=None, device=CPU)
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    for name, (arch, shape, lr, q8) in cases.items():
        b = build_step(arch, shape, mesh, reduced=True,
                       opt=AdamWConfig(lr=lr, quantize_moments=q8))
        args = local_args(b, *torch.load(os.path.join(case_dir,
                                                      f"{name}.pt")))
        with _MomentSpy(args[1]) as ms:
            out = b.fn(*args)
        torch.save({"moments": [{"largest": ms.largest,
                                 "gathered": ms.gathered}],
                    "moment_limits": moment_limits(b)},
                   os.path.join(out_dir, f"{name}_moments_{dist.get_rank()}"
                                ".pt"))
        params, state, loss = gather_outputs(b, out)
        if dist.get_rank() == 0:
            torch.save({"params": params, "state": state, "loss": loss},
                       os.path.join(out_dir, f"{name}.pt"))


def compress_cases(case_dir: str, out_dir: str) -> None:
    """``compress_psum`` over the mesh's data axis of each rank's
    gradient tree (``grads_<rank>.pt``); every rank writes its sum."""
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.optim import compress_psum

    rank = dist.get_rank()
    grads = torch.load(os.path.join(case_dir, f"grads_{rank}.pt"))
    mesh = make_host_mesh(max_data=None, device=CPU)
    with use_mesh(mesh):
        out = compress_psum(grads, "data")
    torch.save(out, os.path.join(out_dir, f"sum_{rank}.pt"))


def card_shard_case(out_dir: str) -> None:
    """The shard backend over an NCCL group on cuda:0 (one rank; more
    must fail, as NCCL refuses two ranks on one device): a chung_lu
    graph's semicore* decompose, written by every rank that gets there."""
    from repro_torch.core import ShardedBackend, decompose
    from repro_torch.graph import chung_lu

    assert dist.get_backend() == "nccl"
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    g = chung_lu(3000, 20000, seed=4)
    r = decompose(g, "semicore*", "batch", block_edges=64,
                  backend=ShardedBackend(group=dist.group.WORLD,
                                         device=device))
    np.savez(os.path.join(out_dir, f"card_{dist.get_rank()}.npz"),
             **result_record(r))


def _param_storages(tree) -> dict:
    """Storage pointer -> the dotted name of the leaf of ``tree`` on it."""
    from repro_torch.models.params import tree_leaves

    return {t.untyped_storage().data_ptr(): n for n, t in tree_leaves(tree)}


class _GatherSpy:
    """Counts ``all_gather`` calls and those whose input shares storage
    with a tensor of ``storages`` (a weight gathered as it is), and names
    those weights (``names``, one a call)."""

    def __init__(self, storages: dict):
        self.storages, self.calls, self.of_weights = storages, 0, 0
        self.names = []
        self._orig = dist.all_gather

    def __enter__(self):
        def spy(out, x, *a, **kw):
            self.calls += 1
            name = self.storages.get(x.untyped_storage().data_ptr())
            if name is not None:
                self.of_weights += 1
                self.names.append(name)
            return self._orig(out, x, *a, **kw)

        dist.all_gather = spy
        return self

    def __exit__(self, *exc):
        dist.all_gather = self._orig


class _MomentSpy:
    """Records, for each leaf of an AdamW state's ``mu``, the largest
    moment tensor this rank forms in ``optim.adamw_update`` (elements of
    what ``q8_decode`` returns, of what ``q8_encode`` is given, and of the
    float32 m and v it updates: ``largest``) and the all-gathers whose
    input is a moment's storage (``gathered``, the leaves by name)."""

    def __init__(self, state):
        from repro_torch.models.params import tree_leaves

        self.leaf_of = {t.untyped_storage().data_ptr(): name.rsplit(".", 1)[0]
                        for name, t in tree_leaves(state["mu"])}
        self.largest, self.gathered, self.leaf = {}, [], None

    def _seen(self, *xs) -> None:
        n = max(x.numel() for x in xs)
        self.largest[self.leaf] = max(self.largest.get(self.leaf, 0), n)

    def __enter__(self):
        from repro_torch.optim import optimizer as opt

        self.module, self._orig = opt, {
            k: getattr(opt, k) for k in ("_update_leaf", "q8_decode",
                                         "q8_encode")}
        self._gather = dist.all_gather
        orig = self._orig

        def update_leaf(p, g, mu, *a, **kw):
            ptr = next(iter(mu.values())).untyped_storage().data_ptr()
            self.leaf = self.leaf_of.get(ptr)
            if "m" in mu:  # float32 moments: updated as they are
                self._seen(mu["m"], mu["v"])
            return orig["_update_leaf"](p, g, mu, *a, **kw)

        def decode(*a, **kw):
            out = orig["q8_decode"](*a, **kw)
            self._seen(out)
            return out

        def encode(x, *a, **kw):
            self._seen(x)
            return orig["q8_encode"](x, *a, **kw)

        def gather(out, x, *a, **kw):
            name = self.leaf_of.get(x.untyped_storage().data_ptr())
            if name is not None:
                self.gathered.append(name)
            return self._gather(out, x, *a, **kw)

        opt._update_leaf = update_leaf
        opt.q8_decode, opt.q8_encode = decode, encode
        dist.all_gather = gather
        return self

    def __exit__(self, *exc):
        for k, f in self._orig.items():
            setattr(self.module, k, f)
        dist.all_gather = self._gather


def moment_limits(b) -> dict:
    """Leaf name -> the most elements a moment tensor of this rank's
    share may hold in ``b``'s step (its ZeRO-1 placement,
    ``in_shardings[1]``): the float32 moments' piece, or the rank's range
    of int8 blocks and one block's padding."""
    from repro_torch.models.params import tree_leaves

    sh = dict(tree_leaves(b.in_shardings[1]["mu"]))
    out = {}
    for name, (shape, _) in tree_leaves(b.args[1]["mu"]):
        leaf, key = name.rsplit(".", 1)
        if key == "m":
            out[leaf] = int(np.prod(shape)) // sh[name].frac
        elif key == "m_q":
            out[leaf] = (shape[0] // sh[name].frac + 1) * shape[1]
    return out


def moment_faults(rec: dict) -> list:
    """What a rank's record (:func:`_train_case`, or a ``train_cases``
    moments file) shows of moments joined: a moment gathered, or a leaf
    whose largest moment tensor passed its share (``moment_limits``)."""
    faults, limits = [], rec["moment_limits"]
    for i, seen in enumerate(rec["moments"]):
        at = f"step {i + 1}"
        faults += [f"{at}: {n} gathered" for n in seen["gathered"]]
        if set(seen["largest"]) != set(limits):
            faults.append(f"{at}: leaves seen {sorted(seen['largest'])}")
        faults += [f"{at}: {n} formed {k} > {limits.get(n)}"
                   for n, k in seen["largest"].items()
                   if k > limits.get(n, -1)]
    return faults


def tp_cases(case_dir: str, params_dir: str, out_dir: str, data: str,
             model: str) -> None:
    """Tensor-parallel LM serving over a ``(data, model)`` mesh of the
    group: each case's global params, tokens and caches
    (``<params_dir>/<arch>.pt``, ``<case_dir>/<case>.pt`` written by the
    test) cut to this rank's pieces, the
    prefill or every decode step run; every rank writes its pieces, the
    logits joined whole, whether each decode step wrote into its cache
    pieces and the gathers it made (``<case>_<rank>.pt``).
    Then the weights gathered as they are, once, to show the spy sees
    it."""
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import (_whole, _zip_map, build_step,
                                          gather_outputs, local_args)

    torch.set_num_threads(1)
    shape, axes = (int(data), int(model)), ("data", "model")
    mesh = Mesh(shape, axes, [CPU], _device_mesh(shape, axes, CPU))
    rank = dist.get_rank()
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    params_of = {}
    for name, case in cases.items():
        arch, cell = case["arch"], case["shape"]
        b = build_step(arch, cell, mesh, reduced=True)
        if arch not in params_of:
            whole = torch.load(os.path.join(params_dir, f"{arch}.pt"))
            params_of[arch] = local_args(b, whole)[0]
        params = params_of[arch]
        args = torch.load(os.path.join(case_dir, f"{name}.pt"))
        rec = {"coords": mesh.coords()}
        with _GatherSpy(_param_storages(params)) as spy:
            if cell == "prefill_32k":
                _, tokens = local_args(b, None, args["tokens"])
                logits = b.fn(params, tokens)
                rec["logits_piece"] = logits
                rec["logits"] = [gather_outputs(b, logits)]
            else:
                _, _, caches = local_args(b, None, None, args["caches"])
                rec["logits"], rec["logits_pieces"] = [], []
                rec["written"] = []
                for tok in args["tokens"]:
                    _, tokens, _ = local_args(b, None, tok, None)
                    before = [caches[k].clone() for k in ("k", "v")]
                    logits, caches = b.fn(params, tokens, caches)
                    rec["written"].append(not all(
                        torch.equal(x, caches[k])
                        for x, k in zip(before, ("k", "v"))))
                    rec["logits_pieces"].append(logits)
                    rec["logits"].append(
                        _whole(logits, b.out_shardings[0]))
                rec["caches"] = caches
        rec["gathers"], rec["weight_gathers"] = spy.calls, spy.of_weights
        torch.save(rec, os.path.join(out_dir, f"{name}_{rank}.pt"))
    # the spy's control: the weights gathered whole as they are
    b = build_step(cases[next(iter(cases))]["arch"], "prefill_32k", mesh,
                   reduced=True)
    params = next(iter(params_of.values()))
    with _GatherSpy(_param_storages(params)) as spy:
        _zip_map(_whole, params, b.in_shardings[0])
    torch.save({"gathers": spy.calls, "weight_gathers": spy.of_weights},
               os.path.join(out_dir, f"control_{rank}.pt"))


def tp_mind_gnn_cases(case_dir: str, out_dir: str, data: str,
                      model: str) -> None:
    """MIND's serve and retrieval steps and the GNN train step over a
    ``(data, model)`` mesh of the group: each case's global arguments
    (``<case_dir>/<case>.pt``, MIND's whole parameters in ``mind.pt``) cut
    to this rank's pieces, the step run and its outputs joined whole.  A
    MIND case also writes the profile bags of its whole batch on this
    rank's row piece (summed over ``model``), and an ``IndexError`` the
    step raised.  Every rank writes ``<case>_<rank>.pt``."""
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import (_model_tp, build_step,
                                          gather_outputs, local_args)
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig

    torch.set_num_threads(1)
    shape, axes = (int(data), int(model)), ("data", "model")
    mesh = Mesh(shape, axes, [CPU], _device_mesh(shape, axes, CPU))
    rank = dist.get_rank()
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    mind = torch.load(os.path.join(case_dir, "mind.pt"))
    for name, case in cases.items():
        args = torch.load(os.path.join(case_dir, f"{name}.pt"))
        rec = {"coords": mesh.coords()}
        if case["arch"] == "mind":
            b = build_step("mind", case["shape"], mesh, reduced=True)
            params, batch = local_args(b, mind, args)
            try:
                rec["out"] = gather_outputs(b, b.fn(params, batch))
            except IndexError as e:
                rec["raised"] = str(e)
            with torch.inference_mode():
                flat = args["profile_ids"].reshape(
                    -1, args["profile_ids"].shape[-1])
                try:
                    rec["bags"] = recsys._profile_bags(
                        params["profile_embed"], flat, _model_tp(mesh))
                except IndexError as e:
                    rec["bags_raised"] = str(e)
        else:
            b = build_step(case["arch"], case["shape"], mesh, reduced=True,
                           opt=AdamWConfig(lr=case["lr"]))
            params, state, loss = gather_outputs(
                b, b.fn(*local_args(b, *args)))
            rec.update(params=params, state=state, loss=loss)
        torch.save(rec, os.path.join(out_dir, f"{name}_{rank}.pt"))


def _mesh_of(data: str, model: str):
    from repro_torch.launch.mesh import Mesh, _device_mesh

    shape, axes = (int(data), int(model)), ("data", "model")
    return Mesh(shape, axes, [CPU], _device_mesh(shape, axes, CPU))


def _tp_functions(mesh, case_dir: str) -> dict:
    """Megatron's three autograd Functions alone (``functions.pt``: x
    (B, E) whole, W (E, N) cut by columns, C (B, N)): ``copy_to`` and
    ``reduce`` around a column-parallel product, the loss summed over the
    ranks; ``gather`` of that product, each rank reading the next rank's
    columns of it; ``max`` of each rank's row maxima of x @ W.  Returns
    the losses, the gradients of x (whole) and of this rank's W piece."""
    from repro_torch.launch.steps import _model_tp

    z = torch.load(os.path.join(case_dir, "functions.pt"))
    tp = _model_tp(mesh)
    N = z["W"].shape[1]
    n = N // tp.size

    def cols(r):
        return slice(r * n, (r + 1) * n)

    out = {}
    for name in ("copy_reduce", "gather"):
        x = z["x"].clone().requires_grad_(True)
        w = z["W"][:, cols(tp.index)].clone().requires_grad_(True)
        y = tp.copy_to(x) @ w
        if name == "copy_reduce":
            part = (y * z["C"][:, cols(tp.index)]).sum()
        else:
            nxt = (tp.index + 1) % tp.size
            part = (tp.gather(y)[:, cols(nxt)] * z["C"][:, cols(nxt)]).sum()
        loss = tp.reduce(part)
        gx, gw = torch.autograd.grad(loss, [x, w])
        out[name] = {"loss": loss.detach(), "grad_x": gx, "grad_w": gw}
    with torch.no_grad():
        out["max"] = tp.max((z["x"] @ z["W"][:, cols(tp.index)]).amax(-1))
    return out


def _copied(tree):
    """A copy of a tree of tensors (the next step updates its leaves in
    place)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copied(x) for x in tree)
    if hasattr(tree, "keys"):
        return {k: _copied(tree[k]) for k in tree.keys()}
    return tree.detach().clone()


def tp_train_cases(case_dir: str, out_dir: str, data: str, model: str,
                   ckpt: str) -> None:
    """The LM and MIND train steps over a ``(data, model)`` mesh of the
    group: each case's two steps (``<case_dir>/<case>.pt``: the whole
    params and AdamW state before each step, and its batch), each from
    that state cut to this rank's pieces, its outputs joined whole.  Every
    rank writes its pieces and the whole outputs after each step and the
    all-gathers the steps made (``<case>_<rank>.pt``), and the autograd
    Functions alone (``functions_<rank>.pt``).  ``ckpt`` ``save:<dir>``:
    after step 1 of a case marked ``ckpt`` rank 0 writes the joined
    (params, state) under ``<dir>/<case>``; ``restore:<dir>``: such a
    case is also restored from there onto this mesh's placements and its
    step 2 run (``restored``)."""
    torch.set_num_threads(1)
    mesh = _mesh_of(data, model)
    rank = dist.get_rank()
    mode, ckpt_dir = ckpt.split(":", 1)
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    if os.path.exists(os.path.join(case_dir, "functions.pt")):
        torch.save({"coords": mesh.coords(),
                    **_tp_functions(mesh, case_dir)},
                   os.path.join(out_dir, f"functions_{rank}.pt"))
    for name, case in cases.items():
        z = torch.load(os.path.join(case_dir, f"{name}.pt"))
        torch.save(_train_case(mesh, name, case, z, mode, ckpt_dir),
                   os.path.join(out_dir, f"{name}_{rank}.pt"))


def train_bundle(case: dict, mesh=None):
    """A train case's step (``case``: ``arch``, ``shape``, ``opt``, and
    ``rows`` where the batch has that many rows of the reduced cell's
    length instead of its own) on ``mesh`` (None: one device)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import lm_specs
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig

    opt = AdamWConfig(**case["opt"])
    if "rows" not in case:
        return steps.build_step(case["arch"], case["shape"], mesh,
                                reduced=True, opt=opt)
    cfg = get_config(case["arch"]).reduced()
    (_, S), dt = lm_specs(cfg, case["shape"], reduced=True)["tokens"]
    avals = {k: ((case["rows"], S), dt) for k in ("tokens", "labels")}
    return steps._build_lm(cfg, case["shape"], "train", avals, mesh, opt,
                           False)


def _train_case(mesh, name: str, case: dict, z: dict, mode: str = "none",
                ckpt_dir: str = "") -> dict:
    """One train case's steps on this rank (``z``: the whole params and
    AdamW state before each step, and its batch), each from that state cut
    to this rank's pieces, its outputs joined whole; the record of
    :func:`tp_train_cases`, with the MoE layers' routes and batch splits
    of each step (``_RouteSpy``)."""
    from repro_torch.launch.steps import gather_outputs, local_args
    from repro_torch.train import checkpoint

    rank = dist.get_rank()
    b = train_bundle(case, mesh)
    rec = {"coords": mesh.coords(), "whole": [], "pieces": [],
           "gathers": 0, "weight_gathers": 0, "routes": [], "splits": [],
           "moments": [], "moment_limits": moment_limits(b)}
    for i, (before, batch) in enumerate(zip(z["states"], z["batches"])):
        params, state = local_args(b, *before)[:2]
        batch = local_args(b, None, None, *batch)[2:]
        with _GatherSpy(_param_storages(params)) as spy, _RouteSpy() as rs, \
                _MomentSpy(state) as ms:
            params, state, loss = b.fn(params, state, *batch)
        rec["gathers"] += spy.calls
        rec["weight_gathers"] += spy.of_weights
        rec["routes"].append(rs.routes)
        rec["splits"].append(rs.splits)
        rec["moments"].append({"largest": ms.largest,
                               "gathered": ms.gathered})
        whole = _copied(gather_outputs(b, (params, state, loss)))
        rec["whole"].append(whole)
        rec["pieces"].append(_copied((params, state)))
        if i == 0 and case.get("ckpt") and mode == "save":
            if rank == 0:
                checkpoint.save(os.path.join(ckpt_dir, name), 1, whole[:2])
            dist.barrier()
    if case.get("ckpt") and mode == "restore":
        (params, state), step = checkpoint.restore(
            os.path.join(ckpt_dir, name), z["states"][0],
            shardings=b.in_shardings[:2])
        batch = local_args(b, None, None, *z["batches"][1])[2:]
        rec["restored_step"] = step
        rec["restored"] = gather_outputs(b, b.fn(params, state, *batch))
    return rec


#: the card's MIND train case: users, AdamW (eps as tests/test_torch_tp_
#: train.py's EPS, so that a gradient near 0 keeps the hold well posed)
CARD_MIND = {"users": 64, "seed": 1, "lr": 1e-3, "eps": 1e-4}


def card_mind_batch(cfg, device) -> dict:
    """The card's MIND train batch (``RecsysSource``) on ``device``."""
    from repro_torch.data import RecsysSource

    batch = RecsysSource(cfg, CARD_MIND["users"], seed=CARD_MIND["seed"])(0)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def card_mind_train_case(out_dir: str) -> None:
    """MIND's reduced train step over a (1, 2) mesh of gloo ranks sharing
    cuda:0 (its rows over ``model``, kernel #4 on each rank's row piece):
    the seeded weights drawn on the card, cut to this rank's pieces, one
    step with the bag's launches counted; every rank writes the joined
    loss, parameters and moments and its launches (``card_mind_<rank>.pt``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import embedding_bag as ebk
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import build_step, gather_outputs, \
        local_args
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig, adamw_init

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    shape, axes = (1, 2), ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    cfg = get_config("mind").reduced()
    opt = AdamWConfig(lr=CARD_MIND["lr"], eps=CARD_MIND["eps"])
    b = build_step("mind", "train_batch", mesh, reduced=True, opt=opt)
    whole = recsys.mind_init(cfg, torch.Generator(device).manual_seed(0))
    args = local_args(b, whole, adamw_init(whole, opt),
                      card_mind_batch(cfg, device))
    ebk.reset_launch_counts()
    out = b.fn(*args)
    torch.cuda.synchronize(device)
    launches = ebk.LAUNCHES["embedding_bag"]
    params, state, loss = gather_outputs(b, out)
    torch.save({"launches": launches, "loss": float(loss),
                "params": _copied(params), "mu": _copied(state["mu"])},
               os.path.join(out_dir, f"card_mind_{dist.get_rank()}.pt"))


class _Traffic:
    """Records each ``all_gather`` and ``all_reduce`` call made while it is
    entered: ``(op, the group's global ranks, dtype name, bytes)``, the
    bytes those a rank receives from the others for an all-gather
    (``(size - 1)`` times its input) and its input for an all-reduce."""

    def __init__(self):
        self.calls = []
        self._orig = dist.all_gather, dist.all_reduce

    def _group(self, kw) -> tuple:
        return tuple(dist.get_process_group_ranks(kw["group"]))

    def __enter__(self):
        gather, reduce = self._orig

        def all_gather(out, x, *a, **kw):
            self.calls.append(("all_gather", self._group(kw), str(x.dtype),
                               (len(out) - 1) * x.numel() * x.element_size()))
            return gather(out, x, *a, **kw)

        def all_reduce(x, *a, **kw):
            self.calls.append(("all_reduce", self._group(kw), str(x.dtype),
                               x.numel() * x.element_size()))
            return reduce(x, *a, **kw)

        dist.all_gather, dist.all_reduce = all_gather, all_reduce
        return self

    def __exit__(self, *exc):
        dist.all_gather, dist.all_reduce = self._orig


class _RouteSpy:
    """Records each ``moe_apply`` call of the transformer: its input (the
    tensor every model rank must hold alike), the top-k expert ids it
    routes that input to, computed as ``moe_apply`` computes them, the
    batch split it was given (``(size, index, rows)`` of its ``dp``, or
    None), the assignments it dropped (``aux["dropped"]``: this rank's
    tokens' assignments past the capacity, over every expert), its output
    and the collectives it made (:class:`_Traffic`'s records)."""

    def __init__(self):
        from repro_torch.models import transformer

        self.module, self.inputs, self.routes = transformer, [], []
        self.splits, self.dropped, self.outputs = [], [], []
        self.traffic = []
        self._orig = transformer.moe_apply

    def __enter__(self):
        def spy(p, cfg, x, *a, **kw):
            with torch.no_grad():
                x0 = x.detach()
                probs = torch.softmax(x0.reshape(-1, x.shape[-1]).float()
                                      @ p["router"].detach().float(), dim=-1)
                self.inputs.append(x0.clone())
                self.routes.append(torch.topk(probs, cfg.moe.top_k).indices)
            dp = kw.get("dp")
            self.splits.append(None if dp is None
                               else (dp.size, dp.index, dp.rows))
            aux = {}
            with _Traffic() as traffic:
                out = self._orig(p, cfg, x, *a, aux=aux, **kw)
            self.dropped.append(int(aux["dropped"]))
            self.outputs.append(out.detach().clone())
            self.traffic.append(traffic.calls)
            return out

        self.module.moe_apply = spy
        return self

    def __exit__(self, *exc):
        self.module.moe_apply = self._orig


def tp_moe_cases(case_dir: str, params_dir: str, out_dir: str, data: str,
                 model: str) -> None:
    """MoE and MLA serving over a ``(data, model)`` mesh of the group:
    each case's global params (``<params_dir>/<params>.pt``), tokens and
    caches (``<case_dir>/<case>.pt``) cut to this rank's pieces, the
    prefill or every decode step run through ``build_step``
    (:func:`_serve_case`); every rank writes ``<case>_<rank>.pt``."""
    torch.set_num_threads(1)
    mesh = _mesh_of(data, model)
    rank = dist.get_rank()
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    params_of = {}
    for name, case in cases.items():
        args = torch.load(os.path.join(case_dir, f"{name}.pt"))
        torch.save(_serve_case(mesh, case, args, params_dir, params_of),
                   os.path.join(out_dir, f"{name}_{rank}.pt"))


def _serve_case(mesh, case: dict, args: dict, params_dir: str,
                params_of: dict) -> dict:
    """One serving case on this rank: its logits (its piece and joined
    whole), its cache pieces, whether each decode step wrote into them,
    the MoE layers' inputs, routes and batch splits, and the all-gathers
    it made (the weights among their inputs by name).  A case marked
    ``seq_alone`` runs ``serve_decode`` on the whole weights with the
    cache's sequence cut over ``model`` and no tensor parallelism.
    ``params_of`` keeps each params name's pieces between cases."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (_comm, _whole, build_step,
                                          gather_outputs, local_args)
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import SequenceSplit

    arch, cell = case["arch"], case["shape"]
    b = build_step(arch, cell, mesh, reduced=True)
    if case.get("seq_alone"):
        params = torch.load(os.path.join(params_dir, f"{case['params']}.pt"))
    else:
        if case["params"] not in params_of:
            whole = torch.load(os.path.join(params_dir,
                                            f"{case['params']}.pt"))
            params_of[case["params"]] = local_args(b, whole)[0]
        params = params_of[case["params"]]
    rec = {"coords": mesh.coords()}
    with _GatherSpy(_param_storages(params)) as spy, _RouteSpy() as rs:
        if cell == "prefill_32k":
            _, tokens = local_args(b, None, args["tokens"])
            logits = b.fn(params, tokens)
            rec["logits_piece"] = logits
            rec["logits"] = [gather_outputs(b, logits)]
        else:
            _, _, caches = local_args(b, None, None, args["caches"])
            keys = [k for k in caches if k != "len"]
            seq = SequenceSplit(_comm(mesh, "model"), mesh.shape["model"],
                                mesh.axis_index("model"))
            rec.update(logits=[], logits_pieces=[], written=[])
            for tok in args["tokens"]:
                _, tokens, _ = local_args(b, None, tok, None)
                before = [caches[k].clone() for k in keys]
                if case.get("seq_alone"):
                    cfg = get_config(arch).reduced()
                    with torch.inference_mode():
                        logits, caches = tfm.serve_decode(
                            params, cfg, tokens, caches, seq=seq)
                    rec["logits"].append(logits)
                else:
                    logits, caches = b.fn(params, tokens, caches)
                    rec["logits_pieces"].append(logits)
                    rec["logits"].append(_whole(logits, b.out_shardings[0]))
                rec["written"].append(not all(
                    torch.equal(x, caches[k]) for x, k in zip(before, keys)))
            rec["caches"] = caches
    rec["gathers"], rec["weight_gathers"] = spy.calls, spy.of_weights
    rec["gathered_weights"] = spy.names
    rec["moe_inputs"], rec["routes"] = rs.inputs, rs.routes
    rec["splits"], rec["dropped"] = rs.splits, rs.dropped
    rec["moe_outputs"], rec["traffic"] = rs.outputs, rs.traffic
    return rec


def moe_data_cases(case_dir: str, params_dir: str, out_dir: str, data: str,
                   model: str) -> None:
    """MoE serving and training over a ``(data, model)`` mesh of the group
    whose batch axes are wider than 1, in one start: the serving cases of
    ``cases.json`` (:func:`_serve_case`) and the train cases of
    ``train_cases.json`` (:func:`_train_case`, their states and batches in
    ``train_<case>.pt``).  Every rank writes ``<case>_<rank>.pt``."""
    torch.set_num_threads(1)
    mesh = _mesh_of(data, model)
    rank = dist.get_rank()
    params_of = {}
    for kind in ("cases", "train_cases"):
        with open(os.path.join(case_dir, f"{kind}.json")) as f:
            cases = json.load(f)
        for name, case in cases.items():
            if kind == "cases":
                args = torch.load(os.path.join(case_dir, f"{name}.pt"))
                rec = _serve_case(mesh, case, args, params_dir, params_of)
            else:
                z = torch.load(os.path.join(case_dir, f"train_{name}.pt"))
                rec = _train_case(mesh, name, case, z)
            torch.save(rec, os.path.join(out_dir, f"{name}_{rank}.pt"))


#: the card's MoE and MLA decode case: the ids' reduced configs in bf16 on a
#: (1, 2) mesh, three decode_32k steps from one below the piece boundary
CARD_MOE = {"archs": ("deepseek-v3-671b", "arctic-480b"), "steps": 3,
            "mesh": (1, 2)}


def card_moe_cell(arch: str, mesh=None):
    """``(cfg, decode bundle)`` of the card's MoE case: ``arch``'s reduced
    config in bf16, its decode_32k step (on ``mesh``'s ranks)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import lm_specs
    from repro_torch.launch import steps

    cfg = replace(get_config(arch).reduced(), dtype=torch.bfloat16)
    b = steps._build_lm(cfg, "decode_32k", "decode",
                        lm_specs(cfg, "decode_32k", reduced=True), mesh,
                        None, False)
    return cfg, b


def card_moe_inputs(cfg, b, device) -> dict:
    """The card case's cache (seeded with numpy, bf16) and tokens."""
    rng = np.random.default_rng(5)
    (B, _), _ = b.args[1]
    caches = {k: torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                 device=device).to(dtype)
              for k, (shape, dtype) in b.args[2].items() if k != "len"}
    T = next(iter(caches.values())).shape[2]
    caches["len"] = torch.tensor(T // CARD_MOE["mesh"][1] - 1,
                                 dtype=torch.int32, device=device)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32), device=device) for _ in range(CARD_MOE["steps"])]
    return {"caches": caches, "tokens": toks}


def card_tp_moe_case(out_dir: str) -> None:
    """MoE and MLA decode over a (1, 2) mesh of gloo ranks sharing cuda:0
    (:data:`CARD_MOE`): each rank draws its pieces leaf by leaf on the card
    (``local_init``, seed 0), runs the decode steps on its cache piece with
    the flash-decode launches counted from 0, and writes the joined logits,
    its routes and the launches (``card_moe_<arch>_<rank>.pt``)."""
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import _whole, local_args, local_init
    from repro_torch.models import transformer as tfm

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    shape, axes = CARD_MOE["mesh"], ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    for arch in CARD_MOE["archs"]:
        cfg, b = card_moe_cell(arch, mesh)
        params = local_init(tfm.lm_param_specs(cfg), b.in_shardings[0],
                            torch.Generator(device).manual_seed(0))
        x = card_moe_inputs(cfg, b, device)
        _, _, caches = local_args(b, None, None, x["caches"])
        fdk.reset_launch_counts()
        logits = []
        with _RouteSpy() as rs:
            for tok in x["tokens"]:
                lg, caches = b.fn(params, local_args(b, None, tok, None)[1],
                                  caches)
                logits.append(_whole(lg, b.out_shardings[0]).cpu())
        torch.cuda.synchronize(device)
        torch.save({"logits": logits, "launches": dict(fdk.LAUNCHES),
                    "routes": [r.cpu() for r in rs.routes]},
                   os.path.join(out_dir,
                                f"card_moe_{arch}_{dist.get_rank()}.pt"))


#: the card's MoE train case: DeepSeek-V3's reduced config (MLA, a shared
#: expert, MTP) in float32 over a (1, 2) mesh, one train_4k step of AdamW
#: (eps as tests/test_torch_tp_train.py's EPS)
CARD_MOE_TRAIN = {"arch": "deepseek-v3-671b", "mesh": (1, 2), "seed": 3,
                  "opt": {"lr": 1e-3, "eps": 1e-4}}
#: the card's data-rank case: Arctic's reduced config in float32 over a
#: (2, 1) mesh, prefill_32k with its router columns SKEW scaled by 30, so
#: data rank 1 drops assignments that only rank 0's tokens push past the
#: capacity
CARD_MOE_DATA = {"arch": "arctic-480b", "mesh": (2, 1), "seed": 4,
                 "skew": (0, 2, 4, 6)}


def card_moe_train_inputs(device) -> tuple:
    """``(bundle, params, state, batch)`` of the card's MoE train case on
    one device: seeded weights drawn on ``device``, fresh AdamW state,
    seeded tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init

    c = CARD_MOE_TRAIN
    cfg = get_config(c["arch"]).reduced()
    b = steps.build_step(c["arch"], "train_4k", reduced=True,
                         opt=AdamWConfig(**c["opt"]))
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(c["seed"]))
    (B, S), _ = b.args[2]
    rng = np.random.default_rng(c["seed"])
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1)).astype(
        np.int32), device=device)
    return b, params, adamw_init(params, b.static["opt"]), (tok[:, :-1],
                                                            tok[:, 1:])


def card_moe_train_case(out_dir: str) -> None:
    """The card's MoE train step over a (1, 2) mesh of gloo ranks sharing
    cuda:0 (:data:`CARD_MOE_TRAIN`): the one-device inputs cut to this
    rank's pieces, one step; every rank writes the joined loss,
    parameters and moments and its whole leaves
    (``card_moe_train_<rank>.pt``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import (build_step, gather_outputs,
                                          local_args)
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    c = CARD_MOE_TRAIN
    shape, axes = c["mesh"], ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    _, params, state, batch = card_moe_train_inputs(device)
    b = build_step(c["arch"], "train_4k", mesh, reduced=True,
                   opt=AdamWConfig(**c["opt"]))
    out = b.fn(*local_args(b, params, state, *batch))
    torch.cuda.synchronize(device)
    sh = dict(tree_leaves(b.in_shardings[0]))
    whole = {n: t.detach().cpu() for n, t in tree_leaves(out[0])
             if sh[n].frac == 1}
    params, state, loss = gather_outputs(b, out)
    assert get_config(c["arch"]).reduced().mtp_depth == 1
    torch.save({"loss": float(loss), "params": _copied(params),
                "mu": _copied(state["mu"]), "whole": whole},
               os.path.join(out_dir, f"card_moe_train_{dist.get_rank()}.pt"))


def card_moe_data_inputs(device) -> tuple:
    """``(bundle, params, tokens)`` of the card's data-rank case on one
    device: seeded weights drawn on ``device`` with the skewed router,
    seeded tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    c = CARD_MOE_DATA
    cfg = get_config(c["arch"]).reduced()
    b = steps.build_step(c["arch"], "prefill_32k", reduced=True)
    params = tfm.lm_init(cfg, torch.Generator(device).manual_seed(c["seed"]))
    params["layers"]["moe"]["router"][..., list(c["skew"])] *= 30.0
    (B, S), _ = b.args[1]
    rng = np.random.default_rng(c["seed"])
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32), device=device)
    return b, params, tokens


def card_moe_data_case(out_dir: str) -> None:
    """The card's data-rank case over a (2, 1) mesh of gloo ranks sharing
    cuda:0 (:data:`CARD_MOE_DATA`): this rank's row of the prefill with
    the capacity counted over both rows; every rank writes the joined
    logits and its routes (``card_moe_data_<rank>.pt``)."""
    from repro_torch.launch.mesh import Mesh, _device_mesh
    from repro_torch.launch.steps import (build_step, gather_outputs,
                                          local_args)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    c = CARD_MOE_DATA
    shape, axes = c["mesh"], ("data", "model")
    mesh = Mesh(shape, axes, [device], _device_mesh(shape, axes, device))
    _, params, tokens = card_moe_data_inputs(device)
    b = build_step(c["arch"], "prefill_32k", mesh, reduced=True)
    with _RouteSpy() as rs:
        logits = b.fn(*local_args(b, params, tokens))
    torch.cuda.synchronize(device)
    torch.save({"logits": gather_outputs(b, logits).cpu(),
                "routes": [r.cpu() for r in rs.routes],
                "coords": mesh.coords()},
               os.path.join(out_dir, f"card_moe_data_{dist.get_rank()}.pt"))
