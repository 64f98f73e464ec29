"""Serving surfaces of the port: the batched LM decode engine, the
streaming core service and its read replicas, registered by name."""
from .engine import ServeEngine
from .registry import (available_services, create_service, register_service,
                       service_factory)
from ..stream import CoreReplica, CoreService

register_service("lm", ServeEngine)
register_service("core-stream", CoreService)
register_service("core-replica", CoreReplica)

__all__ = [
    "ServeEngine", "CoreService", "CoreReplica",
    "register_service", "service_factory", "create_service",
    "available_services",
]
