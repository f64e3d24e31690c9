"""WaveSim (``examples/wavesim.py``) on the port's runtime: the
triple-buffered 5-point wave loop with a one-row halo exchange, each step
computed by kernel B2 on the ``neighborhood((1, 0))`` slab of its chunk, and
the residual ``reduction(R2, "sum")`` of the squared difference of the two
newest fields.  :func:`budget_program` is the three interleaved simulations
of the memory-budget demo.
"""

from __future__ import annotations

import numpy as np

from ..core import (Box, Runtime, neighborhood, one_to_one, read, reduction,
                    write)
from ..kernels.stencil5 import wave_step_rows, writing_into


def make_step_kernel(H: int, W: int, c: float):
    """Device kernel of one wave step over the rows of its chunk.  B2
    writes the step straight into the chunk's rows of ``un``'s allocation;
    the ``set`` that follows is then a copy onto itself, which ATen skips,
    and stores a step that came back as a fresh tensor."""
    def step_kernel(chunk, um_v, u_v, un_v):
        lo, hi = chunk.min[0], chunk.max[0]
        ext = Box((max(0, lo - 1), 0), (min(H, hi + 1), W))
        with writing_into(un_v.get(chunk)):
            new = wave_step_rows(um_v.get(chunk), u_v.get(ext), lo, H, c)
        un_v.set(chunk, new)
    return step_kernel


def residual_kernel(chunk, ua, ub, red):
    """Contributes the squared difference of two fields over its chunk."""
    d = ub.get(chunk) - ua.get(chunk)
    red.contribute(d * d)


class WaveSim:
    """The program on ``rt``: three ``[H, W]`` fields seeded from ``u0``
    (previous) and ``u1`` (current), in their own dtype, advanced ``steps``
    at a time, and the float64 scalar R2 that :meth:`residual` reduces.
    ``name`` tells the buffers of several simulations on one runtime
    apart."""

    def __init__(self, rt: Runtime, u0: np.ndarray, u1: np.ndarray,
                 c: float = 0.25, *, name: str = "") -> None:
        self.rt, self.shape, self.s = rt, u1.shape, 0
        H, W = u1.shape
        self.step_kernel = make_step_kernel(H, W, c)
        self.B = [rt.buffer((H, W), dtype=u1.dtype, init=u0, name=f"um{name}"),
                  rt.buffer((H, W), dtype=u1.dtype, init=u1, name=f"u{name}"),
                  rt.buffer((H, W), dtype=u1.dtype,
                            init=np.zeros((H, W), u1.dtype), name=f"un{name}")]
        self.R2 = rt.buffer((1,), init=np.zeros(1), name=f"R2{name}")

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

    def residual(self) -> None:
        """Submit the residual reduction |u_s - u_{s-1}|^2 of the two newest
        fields into R2."""
        s = self.s
        self.rt.submit(f"residual{s}", self.shape,
                       [read(self.B[s % 3], one_to_one()),
                        read(self.B[(s + 1) % 3], one_to_one()),
                        reduction(self.R2, "sum")], residual_kernel)

    def gather(self) -> np.ndarray:
        """The newest field."""
        return self.rt.gather(self.B[(self.s + 1) % 3])

    def gather_previous(self) -> np.ndarray:
        """The field before the newest."""
        return self.rt.gather(self.B[self.s % 3])

    def residual_value(self) -> float:
        """R2 as the last :meth:`residual` left it."""
        return float(self.rt.gather(self.R2)[0])


def run_wave(rt: Runtime, u0: np.ndarray, u1: np.ndarray, steps: int,
             c: float = 0.25) -> np.ndarray:
    """Run ``steps`` wave steps from fields ``u0`` (previous) and ``u1``
    (current), ``[H, W]`` in their own dtype; return the newest field."""
    sim = WaveSim(rt, u0, u1, c)
    sim.advance(steps)
    return sim.gather()


def budget_program(rt: Runtime, H: int, W: int, steps: int,
                   dtype=np.float64) -> list[tuple]:
    """``examples/wavesim.py``'s budget demo program: three ``[H, W]``
    simulations, each a splash at its own rows; the first pauses halfway
    while the others run all ``steps``, then finishes, so under a device
    budget its fields are spilled and reloaded.  Each ends with a residual;
    returns ``(newest field, previous field, residual)`` of each."""
    sims = []
    for i in range(3):
        u1 = np.zeros((H, W), dtype)
        o = 8 + 6 * i
        u1[o:o + 6, W // 2 - 3:W // 2 + 3] = 1.0 + 0.25 * i
        sims.append(WaveSim(rt, u1.copy(), u1, name=str(i)))
    sims[0].advance(steps // 2)
    for sim in sims[1:]:
        sim.advance(steps)
        sim.residual()
    sims[0].advance(steps - steps // 2)
    sims[0].residual()
    return [(sim.gather(), sim.gather_previous(), sim.residual_value())
            for sim in sims]
