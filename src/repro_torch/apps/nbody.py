"""The N-body programs of ``examples/quickstart.py`` and ``examples/nbody.py``
on the port's runtime.

Listing 1: ``timestep`` reads all of P and updates its chunk of V with the
forces from kernel B1 on its rows; ``update`` moves its chunk of P.  Every
few steps two adjacent tasks bind scalar reductions, ``reduction(E, "sum")``
over the per-body energies and ``reduction(Mx, "sum")`` over the x-momenta;
the two fuse into one exchange.  :func:`budget_program` is the phased
three-simulation program of the memory-budget demo.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import (Box, Runtime, all_range, one_to_one, read, read_write,
                    reduction)
from ..kernels.nbody import nbody_forces_rows

EPS = 1e-3

# rows per step of :func:`body_energies`: bounds its [rows, N] float64
# temporaries to 2^27 elements (1 GiB) each, a few alive at once.  Each step
# launches about 60 elementwise kernels; on the card the launches, not the
# bytes, set the time when four lanes run the steps at once, so the steps
# are as large as memory allows.
_ENERGY_ELEMENTS = 1 << 27


def _pairwise_leaf(a: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise-sum leaf over the last dim (at most 128 values):
    sequential below 8 values, else eight running sums folded as a tree,
    then the remainder in order."""
    n = a.shape[-1]
    if n < 8:
        res = torch.zeros_like(a[..., 0])
        for i in range(n):
            res = res + a[..., i]
        return res
    r = a[..., 0:8]
    for i in range(8, n - n % 8, 8):
        r = r + a[..., i:i + 8]
    res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
           + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
    for i in range(n - n % 8, n):
        res = res + a[..., i]
    return res


def _pairwise(a: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` over the last dim: leaves of at most 128
    values, halves cut at a multiple of 8."""
    n = a.shape[-1]
    if n <= 128:
        return _pairwise_leaf(a)
    if n % 16 == 0:
        # both halves are n / 2 long: sum them side by side
        h = _pairwise(a.reshape(*a.shape[:-1], 2, n // 2))
        return h[..., 0] + h[..., 1]
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(a[..., :n2]) + _pairwise(a[..., n2:])


# numpy hands a reduction's inner loop at most its buffer size of values
_NP_BUFSIZE = 8192


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in numpy's order for a contiguous float64 row
    (``np.add.reduce``): blocks of 8192 values, each summed pairwise, added
    in sequence.  The order depends on the row's length alone, and every
    step is an elementwise add, so a row's sum has the same bits whatever
    the other dims hold and on any device."""
    n = a.shape[-1]
    if n <= _NP_BUFSIZE:
        return _pairwise(a)
    full = n - n % _NP_BUFSIZE
    blocks = _pairwise(a[..., :full].reshape(*a.shape[:-1], -1, _NP_BUFSIZE))
    res = blocks[..., 0]
    for j in range(1, blocks.shape[-1]):
        res = res + blocks[..., j]
    if full < n:
        res = res + _pairwise(a[..., full:])
    return res


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  CUDA's float64 ``sqrt`` is; PyTorch's
    vectorised CPU one may miss by an ulp, so on the CPU numpy's is used."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def body_energies(p_all: torch.Tensor, v_rows: torch.Tensor, lo: int,
                  hi: int, mass: float) -> torch.Tensor:
    """Per-body energies of rows ``[lo, hi)`` in float64, on ``p_all``'s
    device: kinetic plus half the softened pair potential (softening
    ``EPS``, B1's), as ``examples/nbody.py``'s ``body_energies`` computes
    them, operation for operation and in numpy's summation order.  A row's
    value depends on the whole of ``p_all`` and its own velocity only, so it
    has the same bits under any chunking of the rows."""
    P = p_all.to(torch.float64)
    V = v_rows.to(torch.float64)
    N = P.shape[0]
    # numpy divides the Python float by the array; torch's scalar / tensor
    # multiplies by a reciprocal, so divide a tensor instead
    c = torch.tensor(-0.5 * mass * mass, dtype=torch.float64, device=P.device)
    pot = torch.empty(hi - lo, dtype=torch.float64, device=P.device)
    step = max(1, _ENERGY_ELEMENTS // max(N, 1))
    for b0 in range(lo, hi, step):
        b1 = min(hi, b0 + step)
        r2 = None
        for k in range(3):
            d = P[None, :, k] - P[b0:b1, None, k]
            r2 = d * d if r2 is None else r2 + d * d
        pe = c / _sqrt(r2 + EPS)
        rows = torch.arange(b1 - b0, device=P.device)
        pe[rows, rows + b0] = 0.0                     # no self-interaction
        pot[b0 - lo:b1 - lo] = pairwise_sum(pe)
    sq = V * V
    kin = (0.5 * mass) * ((sq[:, 0] + sq[:, 1]) + sq[:, 2])
    return kin + pot


class NBody:
    """The program on ``rt``: buffers P and V seeded from ``P0`` and ``V0``
    (both ``[N, 3]``, in their own dtype), advanced ``steps`` at a time, and
    the float64 scalars E (total energy) and Mx (x-momentum) that
    :meth:`measure` reduces.  ``name`` tells the buffers of several
    simulations on one runtime apart."""

    def __init__(self, rt: Runtime, P0: np.ndarray, V0: np.ndarray,
                 dt: float, mass: float, *, name: str = "") -> None:
        self.rt, self.N, self.steps = rt, P0.shape[0], 0
        self.P = rt.buffer(P0.shape, dtype=P0.dtype, init=P0, name=f"P{name}")
        self.V = rt.buffer(V0.shape, dtype=V0.dtype, init=V0, name=f"V{name}")
        self.E = rt.buffer((1,), init=np.zeros(1), name=f"E{name}")
        self.Mx = rt.buffer((1,), init=np.zeros(1), name=f"Mx{name}")
        everything = Box((0, 0), (self.N, 3))

        def timestep(chunk, p, v):
            """reads all of P, updates its chunk of V (paper L10-L17)."""
            lo, hi = chunk.min[0], chunk.max[0]
            F = nbody_forces_rows(p.get(everything), lo, hi)
            v.set(chunk, v.get(chunk) + mass * F * dt)

        def update(chunk, v, p):
            """reads its chunk of V, updates its chunk of P (paper L19-L25)."""
            p.set(chunk, p.get(chunk) + v.get(chunk) * dt)

        def energy(chunk, p, v, red):
            lo, hi = chunk.min[0], chunk.max[0]
            red.contribute(body_energies(p.get(everything), v.get(chunk),
                                         lo, hi, mass))

        def momentum(chunk, v, red):
            red.contribute(mass * v.get(chunk)[:, 0])

        self._timestep, self._update = timestep, update
        self._energy, self._momentum = energy, momentum

    def advance(self, steps: int, energy_every: int = 0) -> None:
        """Submit ``steps`` steps; they run asynchronously.  With
        ``energy_every``, :meth:`measure` follows every step whose count
        (over the simulation's life) is a multiple of it."""
        for _ in range(steps):
            self.rt.submit("timestep", (self.N, 3),
                           [read(self.P, all_range()),
                            read_write(self.V, one_to_one())], self._timestep)
            self.rt.submit("update", (self.N, 3),
                           [read(self.V, one_to_one()),
                            read_write(self.P, one_to_one())], self._update)
            self.steps += 1
            if energy_every and self.steps % energy_every == 0:
                self.measure()

    def measure(self, momentum: bool = True) -> None:
        """Submit the energy reduction into E and, with ``momentum``, the
        adjacent x-momentum reduction into Mx (one fused exchange)."""
        self.rt.submit("energy", (self.N, 3),
                       [read(self.P, all_range()), read(self.V, one_to_one()),
                        reduction(self.E, "sum")], self._energy)
        if momentum:
            self.rt.submit("momentum", (self.N, 3),
                           [read(self.V, one_to_one()),
                            reduction(self.Mx, "sum")], self._momentum)

    def gather(self) -> np.ndarray:
        """The positions."""
        return self.rt.gather(self.P)

    def gather_velocities(self) -> np.ndarray:
        return self.rt.gather(self.V)

    def energy(self) -> tuple[float, float]:
        """E and Mx as the last :meth:`measure` left them."""
        return float(self.rt.gather(self.E)[0]), float(self.rt.gather(self.Mx)[0])


def run_nbody(rt: Runtime, P0: np.ndarray, V0: np.ndarray, steps: int,
              dt: float, mass: float) -> np.ndarray:
    """Advance bodies at ``P0`` with velocities ``V0`` by ``steps`` steps on
    ``rt``; return the positions."""
    sim = NBody(rt, P0, V0, dt, mass)
    sim.advance(steps)
    return sim.gather()


def budget_program(rt: Runtime, inits: list[tuple[np.ndarray, np.ndarray]],
                   steps: int, dt: float, mass: float) -> list[float]:
    """``examples/nbody.py``'s budget demo program: one simulation per
    ``(P0, V0)`` of ``inits``; the first pauses halfway while the others run
    all ``steps``, then finishes, so under a device budget its buffers are
    spilled and reloaded.  Each ends with an energy reduction; returns the
    energies."""
    sims = [NBody(rt, P0, V0, dt, mass, name=str(i))
            for i, (P0, V0) in enumerate(inits)]
    sims[0].advance(steps // 2)
    for sim in sims[1:]:
        sim.advance(steps)
        sim.measure(momentum=False)
    sims[0].advance(steps - steps // 2)
    sims[0].measure(momentum=False)
    return [float(rt.gather(sim.E)[0]) for sim in sims]
