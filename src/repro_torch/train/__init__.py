"""Training of the port: the step loop and its checkpoints."""
from .checkpoint import CheckpointManager, latest_step, restore, save
from .trainer import TrainLoop, make_source

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "TrainLoop", "make_source"]
