"""Config dataclasses of the LM, recsys and core-graph families (+ reduced
smoke configs).

The port's copy of ``repro/configs/base.py`` for the families it runs:
``LMConfig`` and ``RecsysConfig`` with ``reduced()``, field for field, with
``dtype`` a torch dtype; ``CoreGraphConfig``, the paper's own workload,
field for field with the port's backend names (the reference's
``"pallas"`` is ``"cuda"``, its ``"xla"`` is ``"torch"``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

__all__ = ["MoEConfig", "MLAConfig", "LMConfig", "RecsysConfig",
           "CoreGraphConfig"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # DeepSeek shared experts
    dense_parallel: bool = False # Arctic: dense residual MLP in parallel
    capacity_factor: float = 1.25
    first_k_dense: int = 0       # DeepSeek: first layers are dense


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp_depth: int = 0           # DeepSeek multi-token prediction modules
    dtype: Any = torch.bfloat16
    kind: str = "lm"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    def reduced(self) -> "LMConfig":
        """Smoke-test scale: same family, tiny dims."""
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=min(8, self.moe.num_experts),
                          d_ff_expert=64, first_k_dense=min(1, self.moe.first_k_dense))
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora=32, kv_lora=16, dh_nope=16, dh_rope=8, dh_v=16)
        return replace(
            self, n_layers=2, d_model=64,
            n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
            moe=moe, mla=mla, mtp_depth=min(self.mtp_depth, 1), dtype=torch.float32,
        )


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 1_000_000
    hist_len: int = 50
    n_profile_fields: int = 8    # multi-hot user-profile bag fields
    profile_vocab: int = 100_000
    profile_bag: int = 16        # slots per bag (EmbeddingBag input)
    mlp_dim: int = 256
    num_sampled_negatives: int = 128
    dtype: Any = torch.float32
    kind: str = "recsys"

    def reduced(self) -> "RecsysConfig":
        return replace(self, n_items=1000, profile_vocab=500, embed_dim=16,
                       hist_len=8, profile_bag=4, mlp_dim=32,
                       num_sampled_negatives=16)


@dataclass(frozen=True)
class CoreGraphConfig:
    """The paper's own workload: web-scale core decomposition (Table I scale)."""
    name: str
    n: int
    m_directed: int
    max_deg: int
    kind: str = "coregraph"
    block_edges: int = 4096      # edge-table block size (storage.DEFAULT_BLOCK_EDGES)
    pool_blocks: int = 1         # BlockReader LRU pool; 1 = paper's single buffer
    build_chunk_edges: int = 1 << 22  # out-of-core build ingest chunk (build.py)
    backend: str = "numpy"       # batch-schedule substrate (core/engine.py):
                                 # numpy | torch | cuda | shard
    num_shards: int | None = None  # shards for backend="shard"
                                 # (engine.ShardedBackend): contiguous edge
                                 # shards minimax-balanced by edge count,
                                 # replicated O(n) core, one gather of owned
                                 # slices a superstep.  None =
                                 # REPRO_TORCH_NUM_SHARDS, else one a GPU
    superstep_chunk: int = 8     # device-resident passes per host round-trip
                                 # (core/resident.py), threaded through
                                 # decompose / CoreMaintainer as
                                 # superstep_chunk=cfg.superstep_chunk;
                                 # REPRO_TORCH_RESIDENT_CHUNK overrides it

    def reduced(self) -> "CoreGraphConfig":
        return replace(self, n=2000, m_directed=16_000, max_deg=64,
                       build_chunk_edges=1 << 12)

    def compute_backend(self, device=None):
        """This cell's batch-schedule backend (``backend``, and for
        ``"shard"`` its ``num_shards``), placed on ``device`` (for
        ``"shard"``, the device of every shard; ``None``: the GPUs)."""
        from ..core.engine import resolve_backend

        return resolve_backend(self.backend, device,
                               num_shards=self.num_shards)
