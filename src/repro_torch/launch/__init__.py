"""Cell assembly of the port: one-device steps (meshes wait for ROADMAP
Queue 1 item 7.7)."""
from .steps import StepBundle, build_step

__all__ = ["StepBundle", "build_step"]
