"""Fault-tolerant checkpointing: atomic step directories.

The port's copy of ``repro/train/checkpoint.py``, on the reference's
on-disk layout: ``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json``,
written to a temporary directory and committed by an atomic rename, so a
crashed save never corrupts the latest checkpoint.  Keys are spelled as
``jax.tree_util.keystr`` spells the reference's paths (``[0]['embed']``,
``[1]['mu']['embed']['m']``, ``[1]['step']``: tuple and list positions,
then dict keys in sorted order), and bfloat16 leaves are stored as their
``uint16`` bits with ``"bfloat16"`` in the manifest.  So a checkpoint
written by either package restores in the other.

A tree here is nested tuples, lists, dicts and
:class:`~repro_torch.models.params.ParamTree` branches over tensors (or numpy
arrays, or Python scalars).  :func:`restore` rebuilds ``like_tree``'s
structure (a ``ParamTree`` as a ``ParamTree``) with each leaf in the like
leaf's dtype, on its device or ``device``.

On a mesh (the reference's ``shardings=``, here trees of
:class:`~repro_torch.launch.mesh.Sharding`): a checkpoint always holds
whole leaves, as the reference's ``np.asarray`` of a sharded array
writes them.  A save from the ranks joins their pieces first
(``launch.steps.gather_outputs``) and one rank writes them; :func:`restore`
with ``shardings`` gives each rank only its piece of every leaf, cut on
the host as ``launch.steps.local_args`` cuts a whole argument, so a
checkpoint saved on one mesh restores onto another mesh's placements or
onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from ..models.params import ParamTree

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

#: torch dtypes as numpy (and the manifest) names them
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def _flatten(tree, path: str = "") -> list:
    """``(keystr, leaf)`` in the reference's flatten order."""
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{path}[{i}]")]
    if isinstance(tree, (dict, ParamTree)):
        return [kv for k in sorted(tree.keys())
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _to_numpy(leaf) -> tuple:
    """``(array to store, dtype name)``: a bfloat16 tensor as its uint16
    bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NAMES[t.dtype]
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree):
    """Host copies of every leaf (before an async save)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_snapshot(x) for x in tree)
    if isinstance(tree, (dict, ParamTree)):
        return {k: _snapshot(tree[k]) for k in tree.keys()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


def save(directory: str, step: int, tree) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        arrays, dtypes = {}, {}
        for key, leaf in _flatten(tree):
            arrays[key], dtypes[key] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                     for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _load_leaf(arr: np.ndarray, stored: str, like, device, sharding=None):
    if stored == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))  # 0-d stays 0-d
    if sharding is not None:
        from ..launch.steps import _piece

        t = _piece(t, sharding)
    if isinstance(like, torch.Tensor):
        dev = like.device if device is None else device
        return t.to(device=dev, dtype=like.dtype)
    return t if device is None else t.to(device)


class _Branch(dict):
    """A restored branch that was a ``ParamTree`` in the like tree."""


def _param_trees(tree):
    """``tree`` with each outermost :class:`_Branch` made a ``ParamTree``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_param_trees(x) for x in tree)
    if isinstance(tree, _Branch):
        with torch.no_grad():
            return ParamTree(tree)
    if isinstance(tree, dict):
        return {k: _param_trees(v) for k, v in tree.items()}
    return tree


def _under(shardings, key):
    """The shardings of ``key``'s subtree (one ``Sharding`` covers every
    leaf under it; None: whole leaves)."""
    from ..launch.mesh import Sharding

    if shardings is None or isinstance(shardings, Sharding):
        return shardings
    return shardings[key]


def restore(directory: str, like_tree, step: int | None = None,
            device=None, shardings=None):
    """Restore into the structure of ``like_tree``; returns ``(tree,
    step)``.  Each leaf takes its like leaf's dtype and device (or
    ``device``); ``step`` None restores the latest.  ``shardings``, a tree
    of ``Sharding`` matching ``like_tree`` (a ``Sharding`` for a whole
    subtree), loads this rank's piece of each leaf instead of all of
    it."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def build(like, key, sh):
            if isinstance(like, (tuple, list)):
                return type(like)(build(x, f"{key}[{i}]", _under(sh, i))
                                  for i, x in enumerate(like))
            if isinstance(like, (dict, ParamTree)):
                out = {k: build(like[k], f"{key}[{k!r}]", _under(sh, k))
                       for k in like.keys()}
                if isinstance(like, ParamTree):  # children as dicts
                    return _Branch(out)
                return out
            return _load_leaf(data[key], manifest["keys"][key]["dtype"],
                              like, device, sh)

        return _param_trees(build(like_tree, "", shardings)), step


class CheckpointManager:
    """Keeps the last `keep` checkpoints; optional async (background) saves."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        host_tree = _snapshot(tree)  # snapshot before async
        self.wait()

        def work():
            try:
                save(self.directory, step, host_tree)
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise()

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def restore_latest(self, like_tree, device=None, shardings=None):
        """:func:`restore` of the latest checkpoint, after the save in
        flight."""
        self.wait()
        return restore(self.directory, like_tree, device=device,
                       shardings=shardings)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
