"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv=8,
    d_ff=4864, vocab=32000, d_head=128,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_parallel=True),
)
