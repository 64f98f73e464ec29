"""Serving of the port: the batched LM decode engine."""
from .engine import ServeEngine

__all__ = ["ServeEngine"]
