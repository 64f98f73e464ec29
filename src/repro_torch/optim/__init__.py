"""Optimizers of the port: AdamW with optional int8 moments."""
from .optimizer import (AdamWConfig, Share, adamw_init, adamw_state_specs,
                        adamw_update, compress_psum, q8_decode, q8_encode)

__all__ = ["AdamWConfig", "Share", "adamw_init", "adamw_update",
           "adamw_state_specs", "q8_encode", "q8_decode", "compress_psum"]
