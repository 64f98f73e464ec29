"""I/O efficient core decomposition on PyTorch and CUDA.

The port of the ``repro`` JAX package to an NVIDIA H100: the paper's
SemiCore / SemiCore+ / SemiCore* decomposition with its I/O accounting,
the warm settle and the masked settle, run device-resident through
hand-written CUDA kernels (``kernels/csrc``); and the model zoo's
serving, MIND (``models.recsys``) on a hand-written EmbeddingBag kernel
and the LM transformers (GQA, MLA, MoE: ``serve.ServeEngine`` decode, GQA
on hand-written flash-decode kernels, and ``models.transformer.
serve_prefill``).  It imports torch and numpy only.

    from repro_torch.core import decompose
    from repro_torch.graph import chung_lu
    r = decompose(chung_lu(10_000, 50_000), "semicore*")   # on cuda:0
"""
