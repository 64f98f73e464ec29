"""Runtime knobs of the PyTorch port, resolved env > argument > default.

The counterpart of ``repro/runtime.py`` for the settings this package
reads.  Each knob has its own ``REPRO_TORCH_*`` variable, so a process can
run the JAX package and the port with different settings side by side.

``backend``          ``REPRO_TORCH_BACKEND``          compute backend name
``device_resident``  ``REPRO_TORCH_DEVICE_RESIDENT``  resident fixpoint (=0 off)
``resident_chunk``   ``REPRO_TORCH_RESIDENT_CHUNK``   supersteps per host sync
``parallel_maint``   ``REPRO_TORCH_PARALLEL_MAINT``   grouped batched maintenance

The environment is read on every call, so a knob can be flipped
mid-process (tests use ``monkeypatch.setenv``).  A :class:`Settings`
snapshot hands a component explicit values; the environment still wins
where the component resolves a knob through :func:`setting`.

``device_resident`` off (the variable ``0``, or a snapshot's ``False``)
means two things on a device backend: a decomposition runs its
supersteps one pass at a time, still on the card, while the maintenance
settle (``CoreMaintainer``'s grouped rounds) runs the seq settle in numpy
on the host.  Times taken in that mode are not the card's.  The
reference's Pallas knobs have no counterpart here (the port's fused
kernels are ``CudaBackend(fused=)``), and telemetry reads
``REPRO_TORCH_OBS`` itself (``obs/metrics.py``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields

__all__ = ["ENV_VARS", "DEFAULTS", "DEFAULT_RESIDENT_CHUNK", "Settings",
           "get_settings", "setting"]

#: knob name -> environment variable
ENV_VARS = {
    "backend": "REPRO_TORCH_BACKEND",
    "device_resident": "REPRO_TORCH_DEVICE_RESIDENT",
    "resident_chunk": "REPRO_TORCH_RESIDENT_CHUNK",
    "parallel_maint": "REPRO_TORCH_PARALLEL_MAINT",
}

#: supersteps per host round-trip of the resident loop
DEFAULT_RESIDENT_CHUNK = 8

_FALSY = ("0", "false", "no", "off")


def _parse_flag(raw: str):
    """Generous boolean: anything but the falsy spellings is on."""
    return raw.strip().lower() not in _FALSY


def _parse_chunk(raw: str):
    try:
        return max(1, int(raw))
    except ValueError:
        return DEFAULT_RESIDENT_CHUNK


_PARSERS = {
    "backend": lambda raw: raw,
    "device_resident": lambda raw: raw != "0",
    "resident_chunk": _parse_chunk,
    "parallel_maint": _parse_flag,
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


@dataclass(frozen=True)
class Settings:
    """Resolved runtime configuration.

    Construct directly for explicit values, or through :meth:`resolve` /
    :func:`get_settings` for the env > override > default order.  Frozen:
    a component handed one sees a consistent snapshot for its lifetime.
    """

    backend: str = "cuda"
    device_resident: bool = True
    resident_chunk: int = DEFAULT_RESIDENT_CHUNK
    parallel_maint: bool = True

    @classmethod
    def resolve(cls, **overrides) -> "Settings":
        """A snapshot with env > override > default per knob (``None``
        overrides mean "not specified")."""
        unknown = set(overrides) - set(ENV_VARS)
        if unknown:
            raise TypeError(f"unknown settings: {sorted(unknown)}")
        return cls(**{k: setting(k, overrides.get(k, _UNSET))
                      for k in ENV_VARS})


DEFAULTS = {f.name: f.default for f in fields(Settings)}


def get_settings(**overrides) -> Settings:
    """``Settings.resolve`` with live env reads."""
    return Settings.resolve(**overrides)
