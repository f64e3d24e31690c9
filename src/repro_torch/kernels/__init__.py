"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: B1 ``nbody_forces_rows`` and B2 ``wave_step_rows``."""

from .nbody import nbody_forces_rows, nbody_forces_rows_plain
from .stencil5 import wave_step_rows, wave_step_rows_plain

__all__ = ["nbody_forces_rows", "nbody_forces_rows_plain",
           "wave_step_rows", "wave_step_rows_plain"]
