"""Registry of serving surfaces.

The port's own copy of ``repro/serve/registry.py``.  The repo serves two
kinds of traffic: token generation (``ServeEngine``, batched LM decode)
and graph-state queries (``CoreService``, streaming core decomposition,
and its read replicas ``CoreReplica``).  Deployments pick a surface by
name; new surfaces register a factory here.
"""
from __future__ import annotations

__all__ = ["register_service", "service_factory", "create_service",
           "available_services"]

_SERVICES: dict[str, type] = {}


def register_service(name: str, factory) -> None:
    if name in _SERVICES and _SERVICES[name] is not factory:
        raise ValueError(f"service {name!r} already registered")
    _SERVICES[name] = factory


def service_factory(name: str):
    try:
        return _SERVICES[name]
    except KeyError:
        raise KeyError(
            f"unknown service {name!r}; available: {available_services()}"
        ) from None


def create_service(name: str, *args, **kwargs):
    return service_factory(name)(*args, **kwargs)


def available_services() -> tuple[str, ...]:
    return tuple(sorted(_SERVICES))
