"""The paper's own workload at Table-I scale: Clueweb / UK / Twitter-sized
semi-external core decomposition cells (directed edge counts = 2m).

The port's copy of ``repro/configs/semicore_webscale.py``: the same cells
under the same names, with the port's backend names (the reference's
``"pallas"`` cell runs on ``"cuda"``).  ``pool_blocks`` sizes the
BlockReader LRU pool (1 is the paper's single block buffer);
``build_chunk_edges`` is the ingest chunk of the external-memory builder
(graph/build.py): peak build memory is O(n) node state +
O(build_chunk_edges) scratch, never O(m).
"""
from .base import CoreGraphConfig

CLUEWEB = CoreGraphConfig(name="semicore-clueweb", n=978_408_098,
                          m_directed=85_148_214_938, max_deg=75_611_696,
                          block_edges=4096, pool_blocks=1,
                          build_chunk_edges=1 << 24)
UK = CoreGraphConfig(name="semicore-uk", n=105_896_555,
                     m_directed=7_477_467_296, max_deg=975_419,
                     block_edges=4096, pool_blocks=1,
                     build_chunk_edges=1 << 24)
TWITTER = CoreGraphConfig(name="semicore-twitter", n=41_652_230,
                          m_directed=2_936_730_364, max_deg=2_997_487,
                          block_edges=4096, pool_blocks=1,
                          build_chunk_edges=1 << 24)
# Pooled variant: the Clueweb cell with a 256-block (~4 MiB) page cache for
# the skip-heavy maintenance / SemiCore* passes.
CLUEWEB_POOLED = CoreGraphConfig(name="semicore-clueweb-pooled",
                                 n=978_408_098, m_directed=85_148_214_938,
                                 max_deg=75_611_696, block_edges=4096,
                                 pool_blocks=256, build_chunk_edges=1 << 24)
# The batch superstep on the hand-written kernels (the reference's Pallas
# cell), sized to the Twitter cell: the backend holds the edge table
# resident on the card, 2m int32 ids = 11.7 GB here.  superstep_chunk=4
# bounds the per-round-trip frontier record at 4 x n bools (~167 MB).
TWITTER_PALLAS = CoreGraphConfig(name="semicore-twitter-pallas",
                                 n=41_652_230, m_directed=2_936_730_364,
                                 max_deg=2_997_487, block_edges=4096,
                                 pool_blocks=1, build_chunk_edges=1 << 24,
                                 backend="cuda", superstep_chunk=4)
# The Clueweb cell on a 256-device mesh (the reference's sharded backend;
# not ported, ROADMAP Queue 1 item 6).
CLUEWEB_SHARD = CoreGraphConfig(name="semicore-clueweb-shard",
                                n=978_408_098, m_directed=85_148_214_938,
                                max_deg=75_611_696, block_edges=4096,
                                pool_blocks=1, build_chunk_edges=1 << 24,
                                backend="shard", num_shards=256,
                                superstep_chunk=8)
CONFIG = CLUEWEB
