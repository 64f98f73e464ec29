"""Architecture registry: arch id -> config object, for every id of the
reference's registry."""
from __future__ import annotations

from importlib import import_module

__all__ = ["ARCH_IDS", "PORTED", "get_config"]

#: arch id -> module under repro_torch.configs
PORTED = {
    "yi-34b": "yi_34b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-0.6b": "qwen3_0_6b",
    "arctic-480b": "arctic_480b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "graphsage-reddit": "graphsage_reddit",
    "gcn-cora": "gcn_cora",
    "schnet": "schnet",
    "egnn": "egnn",
    "mind": "mind",
    "semicore-webscale": "semicore_webscale",
}

ARCH_IDS = [a for a in PORTED if a != "semicore-webscale"]


def get_config(arch_id: str):
    if arch_id not in PORTED:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(PORTED)}")
    return import_module(f"{__package__}.{PORTED[arch_id]}").CONFIG
