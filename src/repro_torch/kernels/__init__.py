"""Hand-written CUDA kernels of the port, each beside its plain torch version.

fused_superstep -- one decomposition superstep per call (row pass + push
                   pass), replacing the TPU's fused Pallas superstep.
segsum          -- segment sum over sorted rows, replacing the TPU's blocked
                   one-hot segment sum.
segsum_active   -- the same sum skipping blocks with no active row (per-block
                   flags once per pass), replacing the TPU's block-skipping
                   segment sum.
embedding_bag   -- pooled gather of table rows per bag (MIND's profile
                   fields), replacing the TPU's scalar-prefetch EmbeddingBag.
flash_decode    -- one-token GQA attention over a KV cache, split-KV partials
                   + combine, replacing the TPU's blocked flash decode.

Kernels are compiled from ``csrc/`` at first use (``_build``); importing
this package builds nothing.
"""
