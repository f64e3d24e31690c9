"""WaveSim (``examples/wavesim.py``) on the port's runtime: the
triple-buffered 5-point wave loop with a one-row halo exchange, each step
computed by kernel B2 on the ``neighborhood((1, 0))`` slab of its chunk.

The residual reduction and the memory-budget demo of the reference wait for
the port's reductions.
"""

from __future__ import annotations

import numpy as np

from ..core import Box, Runtime, neighborhood, one_to_one, read, write
from ..kernels.stencil5 import wave_step_rows


def make_step_kernel(H: int, W: int, c: float):
    """Device kernel of one wave step over the rows of its chunk."""
    def step_kernel(chunk, um_v, u_v, un_v):
        lo, hi = chunk.min[0], chunk.max[0]
        ext = Box((max(0, lo - 1), 0), (min(H, hi + 1), W))
        un_v.set(chunk, wave_step_rows(um_v.get(chunk), u_v.get(ext), lo, H, c))
    return step_kernel


class WaveSim:
    """The program on ``rt``: three ``[H, W]`` fields seeded from ``u0``
    (previous) and ``u1`` (current), in their own dtype, advanced ``steps``
    at a time."""

    def __init__(self, rt: Runtime, u0: np.ndarray, u1: np.ndarray,
                 c: float = 0.25) -> None:
        self.rt, self.shape, self.s = rt, u1.shape, 0
        H, W = u1.shape
        self.step_kernel = make_step_kernel(H, W, c)
        self.B = [rt.buffer((H, W), dtype=u1.dtype, init=u0, name="um"),
                  rt.buffer((H, W), dtype=u1.dtype, init=u1, name="u"),
                  rt.buffer((H, W), dtype=u1.dtype,
                            init=np.zeros((H, W), u1.dtype), name="un")]

    def advance(self, steps: int) -> None:
        """Submit ``steps`` steps; they run asynchronously."""
        B = self.B
        for s in range(self.s, self.s + steps):
            um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
            self.rt.submit(f"wave{s}", self.shape,
                           [read(um, one_to_one()),
                            read(u, neighborhood((1, 0))),
                            write(un, one_to_one())], self.step_kernel)
        self.s += steps

    def gather(self) -> np.ndarray:
        """The newest field."""
        return self.rt.gather(self.B[(self.s + 1) % 3])


def run_wave(rt: Runtime, u0: np.ndarray, u1: np.ndarray, steps: int,
             c: float = 0.25) -> np.ndarray:
    """Run ``steps`` wave steps from fields ``u0`` (previous) and ``u1``
    (current), ``[H, W]`` in their own dtype; return the newest field."""
    sim = WaveSim(rt, u0, u1, c)
    sim.advance(steps)
    return sim.gather()
