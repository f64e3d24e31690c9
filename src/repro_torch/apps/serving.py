"""WaveSim and the N-body served as two tenants of one
:class:`~repro_torch.core.ServingRuntime`.  Each tenant's client thread
advances its simulation one step a window.  A waiting client (the
default) waits for each window before it submits the next, as a client
does that streams every step out; a client that does not wait submits
every window after the first and drains once, so up to
``max_inflight_windows`` of its windows run at once.  After the first few
windows of each shape the runtime replays the memoized instruction window
instead of lowering it again.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import ServingRuntime, neighborhood, one_to_one, read, write
from .nbody import NBody
from .wavesim import make_step_kernel


def _windows(t, step, windows: int, wait: bool) -> dict:
    """Run ``step(s)`` then close the window, ``windows`` times.  A waiting
    client records each window's latency (submission to completion).  One
    that does not wait still waits for its first window, which seeds the
    buffers, then submits the others and drains once.  ``seconds`` runs
    from the end of the first window to the drain."""
    latency = []
    for s in range(windows):
        t0 = time.perf_counter()
        step(s)
        handle = t.run()
        if wait or s == 0:
            handle.wait()
            if wait:
                latency.append(time.perf_counter() - t0)
            if s == 0:
                t_rest = time.perf_counter()
    t.drain()
    return {"latency_s": latency, "seconds": time.perf_counter() - t_rest}


def _wave_client(t, u0: np.ndarray, u1: np.ndarray, windows: int,
                 c: float, wait: bool) -> dict:
    """WaveSim's triple-buffered loop, one step a window.  Every step has
    the same task name, so the windows take three shapes in turn (the
    buffers rotate) and each shape replays once captured."""
    H, W = u1.shape
    kernel = make_step_kernel(H, W, c)
    B = [t.buffer((H, W), dtype=u1.dtype, init=u0, name="um"),
         t.buffer((H, W), dtype=u1.dtype, init=u1, name="u"),
         t.buffer((H, W), dtype=u1.dtype, init=np.zeros_like(u1), name="un")]

    def step(s):
        um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
        t.submit("wave", (H, W), [read(um, one_to_one()),
                                  read(u, neighborhood((1, 0))),
                                  write(un, one_to_one())], kernel)

    times = _windows(t, step, windows, wait)
    return {"field": t.gather(B[(windows + 1) % 3]), **times}


def _nbody_client(t, P0: np.ndarray, V0: np.ndarray, windows: int,
                  dt: float, mass: float, wait: bool) -> dict:
    """The Listing-1 N-body, one step (timestep and update) a window."""
    sim = NBody(t, P0, V0, dt, mass)
    times = _windows(t, lambda s: sim.advance(1), windows, wait)
    return {"P": sim.gather(), **times}


def serve_simulations(srv: ServingRuntime, u0: np.ndarray, u1: np.ndarray,
                      P0: np.ndarray, V0: np.ndarray, *, wave_windows: int,
                      nbody_windows: int, dt: float, mass: float,
                      c: float = 0.25, wait: bool = True) -> dict:
    """Tenant ``wave`` runs WaveSim from fields ``u0`` (previous) and ``u1``
    (current) for ``wave_windows`` windows; tenant ``nbody`` runs the
    N-body from ``P0`` and ``V0`` for ``nbody_windows``.  A tenant given 0
    windows is not created.  The clients submit at once, from their own
    threads; with ``wait`` false they do not wait between windows.
    Returns, per tenant, the gathered result (``field``: the newest field;
    ``P``: the positions), each window's latency in seconds from submission
    to completion (``latency_s``, empty without ``wait``) and the seconds
    from the end of the first window, which seeds the buffers, to the
    drain (``seconds``)."""
    clients = {}
    with ThreadPoolExecutor(2) as pool:
        if wave_windows:
            clients["wave"] = pool.submit(_wave_client, srv.tenant("wave"),
                                          u0, u1, wave_windows, c, wait)
        if nbody_windows:
            clients["nbody"] = pool.submit(_nbody_client,
                                           srv.tenant("nbody"), P0, V0,
                                           nbody_windows, dt, mass, wait)
        return {name: f.result() for name, f in clients.items()}
