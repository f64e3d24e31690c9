"""WaveSim and the N-body served as two tenants of one
:class:`~repro_torch.core.ServingRuntime`: each tenant's client thread
advances its simulation one step a window and waits for the window before
it submits the next, as a client does that streams every step out.  After
the first few windows of each shape the runtime replays the memoized
instruction window instead of lowering it again.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import ServingRuntime, neighborhood, one_to_one, read, write
from .nbody import NBody
from .wavesim import make_step_kernel


def _wave_client(t, u0: np.ndarray, u1: np.ndarray, windows: int,
                 c: float) -> dict:
    """WaveSim's triple-buffered loop, one step a window.  Every step has
    the same task name, so the windows take three shapes in turn (the
    buffers rotate) and each shape replays once captured."""
    H, W = u1.shape
    kernel = make_step_kernel(H, W, c)
    B = [t.buffer((H, W), dtype=u1.dtype, init=u0, name="um"),
         t.buffer((H, W), dtype=u1.dtype, init=u1, name="u"),
         t.buffer((H, W), dtype=u1.dtype, init=np.zeros_like(u1), name="un")]
    latency = []
    for s in range(windows):
        t0 = time.perf_counter()
        um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
        t.submit("wave", (H, W), [read(um, one_to_one()),
                                  read(u, neighborhood((1, 0))),
                                  write(un, one_to_one())], kernel)
        t.run().wait()
        latency.append(time.perf_counter() - t0)
    return {"field": t.gather(B[(windows + 1) % 3]), "latency_s": latency}


def _nbody_client(t, P0: np.ndarray, V0: np.ndarray, windows: int,
                  dt: float, mass: float) -> dict:
    """The Listing-1 N-body, one step (timestep and update) a window."""
    sim = NBody(t, P0, V0, dt, mass)
    latency = []
    for _ in range(windows):
        t0 = time.perf_counter()
        sim.advance(1)
        t.run().wait()
        latency.append(time.perf_counter() - t0)
    return {"P": sim.gather(), "latency_s": latency}


def serve_simulations(srv: ServingRuntime, u0: np.ndarray, u1: np.ndarray,
                      P0: np.ndarray, V0: np.ndarray, *, wave_windows: int,
                      nbody_windows: int, dt: float, mass: float,
                      c: float = 0.25) -> dict:
    """Tenant ``wave`` runs WaveSim from fields ``u0`` (previous) and ``u1``
    (current) for ``wave_windows`` windows; tenant ``nbody`` runs the
    N-body from ``P0`` and ``V0`` for ``nbody_windows``.  Both clients
    submit at once, from their own threads.  Returns, per tenant, the
    gathered result (``field``: the newest field; ``P``: the positions) and
    each window's latency in seconds, from submission to completion."""
    with ThreadPoolExecutor(2) as pool:
        wave = pool.submit(_wave_client, srv.tenant("wave"), u0, u1,
                           wave_windows, c)
        nbody = pool.submit(_nbody_client, srv.tenant("nbody"), P0, V0,
                            nbody_windows, dt, mass)
        return {"wave": wave.result(), "nbody": nbody.result()}
