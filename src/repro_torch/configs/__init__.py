"""Model configurations of the port: the dataclasses of ``repro.configs``
with torch dtypes, and the registry of the ported architectures."""
from .base import LMConfig, MLAConfig, MoEConfig, RecsysConfig
from .registry import ARCH_IDS, PORTED, get_config

__all__ = ["LMConfig", "MLAConfig", "MoEConfig", "RecsysConfig", "ARCH_IDS",
           "PORTED", "get_config"]
