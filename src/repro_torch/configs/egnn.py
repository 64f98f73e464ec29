"""egnn [gnn] — 4 layers, E(n)-equivariant [arXiv:2102.09844]."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="egnn", arch="egnn", n_layers=4, d_hidden=64, equivariance="E(n)",
)
