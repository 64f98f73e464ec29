"""The training loop: steps + checkpoint/resume + data prefetch.

The port's copy of ``repro/train/trainer.py`` for the LM and recsys cells
(reduced configs on the CPU; full width on the card), on one device.
Fault tolerance: checkpoints of (params, opt_state) through the atomic
:class:`~repro_torch.train.checkpoint.CheckpointManager`, in the
reference's layout; resume picks up from the latest committed step and
the step-indexed sources regenerate exactly the batches in flight.  A
checkpoint of the JAX package's loop resumes here, and the other way.
The GNN ids wait for ROADMAP Queue 1 item 7.6 (``get_config`` raises).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch

from ..configs import get_config
from ..configs.shapes import input_specs
from ..core.engine import resolve_device
from ..data.pipeline import Prefetcher, RecsysSource, TokenSource
from ..launch.steps import build_step
from ..models.params import tree_init
from ..optim import AdamWConfig, adamw_init
from .checkpoint import CheckpointManager

__all__ = ["TrainLoop", "make_source"]


def make_source(cfg, shape_name: str, reduced: bool):
    """The step-indexed synthetic source of one train cell (the GNN cells
    raise in ``input_specs``, naming ROADMAP Queue 1 item 7.6)."""
    _, avals = input_specs(cfg, shape_name, reduced=reduced)
    if cfg.kind == "lm":
        B, S = avals["tokens"][0]
        return TokenSource(B, S, cfg.vocab)
    if cfg.kind == "recsys":
        return RecsysSource(cfg, avals["hist_ids"][0][0])
    raise ValueError(f"no train source for kind {cfg.kind!r}")


@dataclass
class TrainLoop:
    arch: str
    shape: str = None
    reduced: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    lr: float = 3e-3
    device: Any = None  # None: cuda:0, raising without a GPU

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = get_config(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        self.cfg = cfg
        if self.shape is None:
            self.shape = {"lm": "train_4k", "recsys": "train_batch"}[cfg.kind]
        self.bundle = build_step(self.arch, self.shape, reduced=self.reduced,
                                 opt=AdamWConfig(lr=self.lr))
        if self.bundle.name != "train_step":
            raise ValueError(f"TrainLoop needs a train cell, got "
                             f"{self.bundle.name!r} for {self.shape!r}")
        self.fn = self.bundle.fn
        self.ckpt = (CheckpointManager(self.checkpoint_dir)
                     if self.checkpoint_dir else None)

    def _init_state(self):
        """Parameters drawn from a generator on the loop's device (seed
        0), and fresh AdamW state."""
        params = tree_init(self.bundle.static["pspecs"],
                           torch.Generator(self.device).manual_seed(0))
        opt_state = adamw_init(params, self.bundle.static["opt"])
        return params, opt_state

    def run(self, num_steps: int, resume: bool = True) -> dict:
        params, opt_state = self._init_state()
        start = 0
        if self.ckpt and resume:
            try:
                (params, opt_state), start = self.ckpt.restore_latest(
                    (params, opt_state))
                start += 1
            except FileNotFoundError:
                pass
        source = make_source(self.cfg, self.shape, self.reduced)
        prefetch = Prefetcher(source, start_step=start)
        losses = []
        t0 = time.time()
        try:
            for i in range(start, start + num_steps):
                _, batch = next(prefetch)
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
                if self.cfg.kind == "lm":
                    params, opt_state, loss = self.fn(
                        params, opt_state, batch["tokens"], batch["labels"])
                else:
                    params, opt_state, loss = self.fn(params, opt_state,
                                                      batch)
                losses.append(float(loss))
                if self.log_every and (i + 1) % self.log_every == 0:
                    print(f"step {i + 1}: loss {losses[-1]:.4f}", flush=True)
                if self.ckpt and (i + 1) % self.checkpoint_every == 0:
                    self.ckpt.save(i, (params, opt_state))
        finally:
            prefetch.close()
        if self.ckpt:
            self.ckpt.save(start + num_steps - 1, (params, opt_state))
            self.ckpt.wait()
        return {"losses": losses,
                "steps_per_s": len(losses) / (time.time() - t0),
                "final_loss": losses[-1] if losses else float("nan")}
