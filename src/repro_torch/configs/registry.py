"""Architecture registry: arch id -> config object.

Knows every id of the reference's registry; only the ported ones load.
The others raise, naming the ROADMAP item that ports them.
"""
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
    "mind": "mind",
    "semicore-webscale": "semicore_webscale",
}

ARCH_IDS = ["yi-34b", "qwen3-14b", "qwen3-0.6b", "arctic-480b",
            "deepseek-v3-671b", "graphsage-reddit", "gcn-cora", "schnet",
            "egnn", "mind"]

_NOT_PORTED = {a: "ROADMAP Queue 1 item 7.6" for a in ARCH_IDS if a not in PORTED}


def get_config(arch_id: str):
    if arch_id in PORTED:
        return import_module(f"{__package__}.{PORTED[arch_id]}").CONFIG
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet "
                                  f"({_NOT_PORTED[arch_id]})")
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{sorted([*PORTED, *_NOT_PORTED])}")
