"""Batched serving engine: prefill + decode loop over a KV cache.

The port's copy of ``repro/serve/engine.py``: fixed request slots sharing
one cache length ``len``; prefill runs the prompt through one decode step
per token; ``generate`` decodes greedily.  The caches are those of
``make_kv_caches``: GQA's k and v, or MLA's compressed latent caches.
They live on ``device``
(default ``cuda:0``; ``device="cpu"`` runs the plain versions) and are
updated in place; every step runs under ``torch.inference_mode()``.
Unlike the reference, which clamps a write past the cache, a request
that would outgrow ``max_len`` raises before it runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import LMConfig
from ..core.engine import resolve_device
from ..models import transformer as tfm

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(self, params, cfg: LMConfig, batch_slots: int, max_len: int,
                 *, device=None):
        """``params`` on ``device``."""
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = batch_slots, max_len
        self.caches = tfm.make_kv_caches(cfg, batch_slots, max_len,
                                         self.device)
        self.length = 0  # host mirror of caches["len"]

    def decode(self, tokens):
        """One decode step for every slot: tokens (B, 1) -> logits
        (B, 1, vocab)."""
        if self.length + 1 > self.max_len:
            raise ValueError(f"the cache holds {self.max_len} positions; "
                             f"step {self.length + 1} would outgrow it")
        with torch.inference_mode():
            tokens = torch.as_tensor(tokens, device=self.device)
            logits, self.caches = tfm.serve_decode(
                self.params, self.cfg, tokens, self.caches)
        self.length += 1
        return logits

    def prefill(self, prompts):
        """prompts (B, S): run the prompt through decode steps (simple path)."""
        B, S = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for {self.batch} slots")
        if self.length + S > self.max_len:
            raise ValueError(f"a prompt of {S} tokens after {self.length} "
                             f"outgrows the cache of {self.max_len}")
        prompts = torch.as_tensor(np.asarray(prompts), device=self.device)
        logits = None
        for i in range(S):
            logits = self.decode(prompts[:, i:i + 1])
        return logits

    def generate(self, prompts, steps: int):
        """Prefill, then ``steps`` greedy tokens: (B, steps) int32 numpy."""
        if self.length + prompts.shape[1] + steps > self.max_len:
            raise ValueError(f"{prompts.shape[1]} + {steps} tokens after "
                             f"{self.length} outgrow the cache of "
                             f"{self.max_len}")
        logits = self.prefill(prompts)
        out = []
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        for _ in range(steps):
            out.append(tok)
            logits = self.decode(tok)
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        return torch.cat(out, dim=1).cpu().numpy()
