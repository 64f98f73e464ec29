"""Hand-written CUDA kernels of the port, each beside its plain torch version.

fused_superstep -- one decomposition superstep per call (row pass + push
                   pass), replacing the TPU's fused Pallas superstep.

Kernels are compiled from ``csrc/`` at first use (``_build``); importing
this package builds nothing.
"""
