"""Host data pipelines of the port."""
from .pipeline import (GNNFullGraphSource, Prefetcher, RecsysSource,
                       SampledGraphSource, TokenSource)

__all__ = ["TokenSource", "GNNFullGraphSource", "SampledGraphSource",
           "RecsysSource", "Prefetcher"]
