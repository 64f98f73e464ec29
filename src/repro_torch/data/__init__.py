"""Host data pipelines of the port."""
from .pipeline import Prefetcher, RecsysSource, TokenSource

__all__ = ["Prefetcher", "RecsysSource", "TokenSource"]
