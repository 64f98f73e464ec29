from .storage import CSRGraph, BlockReader, paper_example_graph, DEFAULT_BLOCK_EDGES
from .generators import (
    chung_lu, rmat, erdos_renyi, ba, make_dataset, DATASET_SUITE,
    rmat_chunks, powerlaw_chunks, uniform_chunks,
)
from .updates import BufferedGraph
from .build import build_csr, BuildStats, edge_chunks_from_npy, edge_chunks_from_text

__all__ = [
    "CSRGraph", "BlockReader", "paper_example_graph", "DEFAULT_BLOCK_EDGES",
    "chung_lu", "rmat", "erdos_renyi", "ba", "make_dataset", "DATASET_SUITE",
    "rmat_chunks", "powerlaw_chunks", "uniform_chunks",
    "BufferedGraph", "build_csr", "BuildStats",
    "edge_chunks_from_npy", "edge_chunks_from_text",
]
