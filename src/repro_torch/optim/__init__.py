"""Optimizer of the port: AdamW and int8 gradient compression with error
feedback.  ``zero1_shardings`` waits for the sharding slice (ROADMAP A19)."""

from .adamw import adamw_init, adamw_update
from .compress import compress_grads, compression_ratio, decompress_grads

__all__ = ["adamw_init", "adamw_update", "compress_grads",
           "compression_ratio", "decompress_grads"]
