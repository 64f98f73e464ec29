"""Model configurations of the port: the dataclasses of ``repro.configs``
with torch dtypes, the paper's web-scale core-graph cells, and the registry
of every architecture."""
from .base import (CoreGraphConfig, GNNConfig, LMConfig, MLAConfig, MoEConfig,
                   RecsysConfig)
from .registry import ARCH_IDS, PORTED, get_config

__all__ = ["CoreGraphConfig", "GNNConfig", "LMConfig", "MLAConfig",
           "MoEConfig", "RecsysConfig", "ARCH_IDS", "PORTED", "get_config"]
