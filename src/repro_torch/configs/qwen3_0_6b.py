"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B; hf]."""
from .base import LMConfig

CONFIG = LMConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv=8,
    d_ff=3072, vocab=151936, d_head=128, qk_norm=True, rope_theta=1_000_000.0,
)
