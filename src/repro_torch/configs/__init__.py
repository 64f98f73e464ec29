"""Model configurations of the port: the dataclasses of ``repro.configs``
with torch dtypes, the paper's web-scale core-graph cells, and the registry
of the ported architectures."""
from .base import CoreGraphConfig, LMConfig, MLAConfig, MoEConfig, RecsysConfig
from .registry import ARCH_IDS, PORTED, get_config

__all__ = ["CoreGraphConfig", "LMConfig", "MLAConfig", "MoEConfig",
           "RecsysConfig", "ARCH_IDS", "PORTED", "get_config"]
