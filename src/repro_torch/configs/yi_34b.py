"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import LMConfig

CONFIG = LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    d_ff=20480, vocab=64000, d_head=128, rope_theta=5_000_000.0,
)
