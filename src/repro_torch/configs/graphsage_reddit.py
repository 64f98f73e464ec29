"""graphsage-reddit [gnn] — mean aggregator, fanout 25-10 [arXiv:1706.02216]."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit", arch="graphsage", n_layers=2, d_hidden=128,
    aggregator="mean", sample_sizes=(25, 10), num_classes=41,
)
