"""Optimizer of the port: AdamW and int8 gradient compression with error
feedback, and the ZeRO-1 placements of the moments."""

from .adamw import adamw_init, adamw_update, zero1_shardings
from .compress import compress_grads, compression_ratio, decompress_grads

__all__ = ["adamw_init", "adamw_update", "compress_grads",
           "compression_ratio", "decompress_grads", "zero1_shardings"]
