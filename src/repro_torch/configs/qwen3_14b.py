"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family; hf]."""
from .base import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv=8,
    d_ff=17408, vocab=151936, d_head=128, qk_norm=True, rope_theta=1_000_000.0,
)
