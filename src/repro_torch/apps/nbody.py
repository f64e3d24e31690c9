"""The paper's Listing-1 N-body program (``examples/quickstart.py``) on the
port's runtime: ``timestep`` reads all of P and updates its chunk of V with
the forces from kernel B1 on its rows; ``update`` moves its chunk of P.
"""

from __future__ import annotations

import numpy as np

from ..core import Box, Runtime, all_range, one_to_one, read, read_write
from ..kernels.nbody import nbody_forces_rows


class NBody:
    """The program on ``rt``: buffers P and V seeded from ``P0`` and ``V0``
    (both ``[N, 3]``, in their own dtype), advanced ``steps`` at a time."""

    def __init__(self, rt: Runtime, P0: np.ndarray, V0: np.ndarray,
                 dt: float, mass: float) -> None:
        self.rt, self.N = rt, P0.shape[0]
        self.P = rt.buffer(P0.shape, dtype=P0.dtype, init=P0, name="P")
        self.V = rt.buffer(V0.shape, dtype=V0.dtype, init=V0, name="V")
        everything = Box((0, 0), (self.N, 3))

        def timestep(chunk, p, v):
            """reads all of P, updates its chunk of V (paper L10-L17)."""
            lo, hi = chunk.min[0], chunk.max[0]
            F = nbody_forces_rows(p.get(everything), lo, hi)
            v.set(chunk, v.get(chunk) + mass * F * dt)

        def update(chunk, v, p):
            """reads its chunk of V, updates its chunk of P (paper L19-L25)."""
            p.set(chunk, p.get(chunk) + v.get(chunk) * dt)

        self._timestep, self._update = timestep, update

    def advance(self, steps: int) -> None:
        """Submit ``steps`` steps; they run asynchronously."""
        for _ in range(steps):
            self.rt.submit("timestep", (self.N, 3),
                           [read(self.P, all_range()),
                            read_write(self.V, one_to_one())], self._timestep)
            self.rt.submit("update", (self.N, 3),
                           [read(self.V, one_to_one()),
                            read_write(self.P, one_to_one())], self._update)

    def gather(self) -> np.ndarray:
        """The positions."""
        return self.rt.gather(self.P)


def run_nbody(rt: Runtime, P0: np.ndarray, V0: np.ndarray, steps: int,
              dt: float, mass: float) -> np.ndarray:
    """Advance bodies at ``P0`` with velocities ``V0`` by ``steps`` steps on
    ``rt``; return the positions."""
    sim = NBody(rt, P0, V0, dt, mass)
    sim.advance(steps)
    return sim.gather()
