"""The paper's applications on the port: the N-body programs (Listing 1,
energy and momentum reductions, the budget demo), WaveSim (with its
residual and budget demo) and RSim, and both simulations served as tenants
of one serving runtime."""

from .nbody import NBody, body_energies, run_nbody
from .rsim import run_rsim
from .serving import serve_simulations
from .wavesim import WaveSim, run_wave

__all__ = ["NBody", "WaveSim", "body_energies", "run_nbody", "run_rsim",
           "run_wave", "serve_simulations"]
