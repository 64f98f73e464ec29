"""schnet [gnn] — 3 interactions, 300 RBF, cutoff 10 [arXiv:1706.08566]."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="schnet", arch="schnet", n_layers=3, d_hidden=64, n_rbf=300,
    cutoff=10.0,
)
