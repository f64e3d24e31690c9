"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: B1 ``nbody_forces_rows``, B2 ``wave_step_rows``, B3
``flash_attention`` and B4 ``ssd_scan`` (its backward's recurrence over
chunks ``ssd_state_pass``)."""

from .flash_attention import flash_attention, flash_attention_plain
from .nbody import nbody_forces_rows, nbody_forces_rows_plain
from .ssd_scan import (ssd_chunk_ref, ssd_scan, ssd_scan_plain,
                       ssd_state_pass, ssd_state_pass_plain)
from .stencil5 import wave_step_rows, wave_step_rows_plain

__all__ = ["flash_attention", "flash_attention_plain",
           "nbody_forces_rows", "nbody_forces_rows_plain",
           "ssd_chunk_ref", "ssd_scan", "ssd_scan_plain",
           "ssd_state_pass", "ssd_state_pass_plain",
           "wave_step_rows", "wave_step_rows_plain"]
