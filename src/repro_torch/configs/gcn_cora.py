"""gcn-cora [gnn] — 2-layer GCN, symmetric norm [arXiv:1609.02907]."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", arch="gcn", n_layers=2, d_hidden=16, aggregator="mean",
    norm="sym", num_classes=7,
)
