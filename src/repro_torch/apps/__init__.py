"""The paper's applications on the port: Listing-1 N-body and WaveSim."""

from .nbody import NBody, run_nbody
from .wavesim import WaveSim, run_wave

__all__ = ["NBody", "WaveSim", "run_nbody", "run_wave"]
