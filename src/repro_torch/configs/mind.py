"""mind [recsys] — 4 interests, 3 capsule iterations [arXiv:1904.08030]."""
from .base import RecsysConfig

CONFIG = RecsysConfig(
    name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
    n_items=1_000_000, hist_len=50,
)
