"""Host data pipelines of the port."""
from .pipeline import RecsysSource, TokenSource

__all__ = ["RecsysSource", "TokenSource"]
