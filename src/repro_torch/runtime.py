"""Runtime knobs of the PyTorch port, resolved env > argument > default.

The counterpart of ``repro/runtime.py`` for the settings this package
reads.  Each knob has its own ``REPRO_TORCH_*`` variable, so a process can
run the JAX package and the port with different settings side by side.

``backend``          ``REPRO_TORCH_BACKEND``          compute backend name
``device_resident``  ``REPRO_TORCH_DEVICE_RESIDENT``  resident fixpoint (=0 off)
``resident_chunk``   ``REPRO_TORCH_RESIDENT_CHUNK``   supersteps per host sync

The environment is read on every call, so a knob can be flipped
mid-process (tests use ``monkeypatch.setenv``).
"""
from __future__ import annotations

import os

__all__ = ["ENV_VARS", "DEFAULTS", "DEFAULT_RESIDENT_CHUNK", "setting"]

#: knob name -> environment variable
ENV_VARS = {
    "backend": "REPRO_TORCH_BACKEND",
    "device_resident": "REPRO_TORCH_DEVICE_RESIDENT",
    "resident_chunk": "REPRO_TORCH_RESIDENT_CHUNK",
}

#: supersteps per host round-trip of the resident loop
DEFAULT_RESIDENT_CHUNK = 8

DEFAULTS = {
    "backend": "cuda",
    "device_resident": True,
    "resident_chunk": DEFAULT_RESIDENT_CHUNK,
}


def _parse_chunk(raw: str):
    try:
        return max(1, int(raw))
    except ValueError:
        return DEFAULT_RESIDENT_CHUNK


_PARSERS = {
    "backend": lambda raw: raw,
    "device_resident": lambda raw: raw != "0",
    "resident_chunk": _parse_chunk,
}

_UNSET = object()


def setting(name: str, override=_UNSET):
    """Resolve one knob: env (if set) > ``override`` (if not None) >
    default."""
    raw = os.environ.get(ENV_VARS[name])
    if raw is not None:
        return _PARSERS[name](raw)
    if override is not _UNSET and override is not None:
        return override
    return DEFAULTS[name]
