"""The Listing-1 N-body (``repro_torch.apps.NBody``) as a benchmark program.

Inputs from the seed as ``chip_smoke.py`` draws them: positions standard
normal, velocities standard normal times 0.1, float32.  A step is
``timestep`` (kernel B1 on each device's rows, after the allgather of P)
and ``update``.

What is compared (``check``), each a gap measured against the step's own
scale:

- ``start_dv``, ``start_dp``: the program's state after its first step
  against the reference's step from the seed's inputs;
- ``end_dv``, ``end_dp``: the program's state after its last step against
  the reference's step from the program's state before it.  An N-body
  step depends on every body, and the reference cannot follow hundreds of
  steps at 2^18 bodies in a run's time, so it follows the program's last
  step from the program's own state; the first step is checked from the
  seed by itself;
- ``drift``: every step of the run, window included, by the centre of
  mass.  Equal masses and antisymmetric pair terms keep the momentum
  ``sum V`` at ``sum V0``, so after ``k`` steps ``sum P`` is
  ``sum P0 + k dt sum V0``.  ``drift`` is the distance from that point over
  ``dt |sum V0|``: a step left out or left unchanged anywhere reads 1, and
  rounding reads hundredths or less.

``dv`` is the largest gap of a velocity component over the median norm of
the reference's velocity change; ``dp`` the largest gap of a position
component over the median of ``|V'| dt``, the step's displacement.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from portbench.harness.common import host
from portbench.reference import no_tf32
from portbench.reference import nbody as ref

CHECKS = ("start_dv", "start_dp", "end_dv", "end_dp", "drift")


def gaps(P, V, P_ref, V_ref, V_prev, dt) -> tuple[float, float]:
    """``(dv, dp)`` of a program state ``(P, V)`` against the reference's
    ``(P_ref, V_ref)`` of the step from velocities ``V_prev``."""
    dev = P_ref.device
    P = torch.as_tensor(P).to(dev, torch.float64)
    V = torch.as_tensor(V).to(dev, torch.float64)
    V_prev = torch.as_tensor(V_prev).to(dev, torch.float64)
    dv_scale = (V_ref - V_prev).norm(dim=1).median()
    dp_scale = V_ref.norm(dim=1).median() * dt
    dv = (V - V_ref).abs().max() / dv_scale
    dp = (P - P_ref).abs().max() / dp_scale
    return float(dv), float(dp)


def drift(P0, V0, P, steps: int, dt: float) -> float:
    """How many steps' worth the centre of mass of ``P`` lies from where
    ``steps`` steps from ``(P0, V0)`` put it (module docstring)."""
    def total(a):
        return torch.as_tensor(a).to(torch.float64).sum(0)
    v = total(V0)
    miss = total(P) - total(P0) - steps * dt * v
    return float(miss.norm() / (dt * v.norm()))


class App:
    checks_start = True      # the check reads the state after step 1
    # the reference in the program's place, in bfloat16: the pair terms
    # computed in it, or the state held in it
    CONTROLS = ("bf16_pairs", "bf16_state")
    tasks_per_step = 2

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = config, seed
        self.device = torch.device(device)
        self.N = int(config["bodies"])
        self.dt = float(config["dt"])
        self.mass = 1.0 / self.N
        rng = np.random.default_rng(seed)
        self.P0 = rng.standard_normal((self.N, 3), dtype=np.float32)
        self.V0 = rng.standard_normal((self.N, 3), dtype=np.float32) * 0.1

    def build(self, rt):
        from repro_torch.apps import NBody
        return NBody(rt, self.P0, self.V0, self.dt, self.mass)

    def advance(self, prog, steps: int) -> None:
        prog.advance(steps)

    def state(self, prog) -> dict:
        return {"P": prog.gather(), "V": prog.gather_velocities()}

    def snapshot_task(self, prog, rt) -> dict:
        """Submit a host task that copies P and V out as the steps before
        it leave them; filled once the runtime has run it."""
        from repro_torch.core import TaskType, one_to_one, read
        out = {"P": np.empty((self.N, 3), np.float32),
               "V": np.empty((self.N, 3), np.float32)}
        lock = threading.Lock()

        def collect(chunk, p, v) -> None:
            rows = slice(chunk.min[0], chunk.max[0])
            P, V = host(p.get(chunk)), host(v.get(chunk))
            with lock:
                out["P"][rows], out["V"][rows] = P, V

        rt.submit("snapshot", (self.N, 3),
                  [read(prog.P, one_to_one()), read(prog.V, one_to_one())],
                  collect, ttype=TaskType.HOST)
        return out

    def _step(self, P, V, control: str | None):
        P = torch.as_tensor(P).to(self.device)
        V = torch.as_tensor(V).to(self.device)
        soft = float(self.cfg["soft"])
        with no_tf32():
            if control is None:
                return ref.step(P, V, self.dt, self.mass, soft)
            lower = {"bf16_pairs": ref.step_pairs_lower,
                     "bf16_state": ref.step_state_lower}[control]
            return lower(P, V, self.dt, self.mass, torch.bfloat16, soft)

    def check(self, start: dict, before: dict, final: dict, steps: int,
              control: str | None = None) -> dict:
        """The compared numbers of a run.  With ``control`` (one of
        ``CONTROLS``) the reference computed in a lower precision stands in
        the program's place: its steps from the same states are compared.
        It stands in for two steps, so it reads no ``drift``."""
        out = {}
        for key, a, b in (("start", {"P": self.P0, "V": self.V0}, start),
                          ("end", before, final)):
            P_ref, V_ref = self._step(a["P"], a["V"], None)
            if control is not None:
                b = dict(zip("PV", self._step(a["P"], a["V"], control)))
            dv, dp = gaps(b["P"], b["V"], P_ref, V_ref, a["V"], self.dt)
            out[f"{key}_dv"], out[f"{key}_dp"] = dv, dp
            del P_ref, V_ref, b
        if control is None:
            out["drift"] = drift(self.P0, self.V0, final["P"], steps,
                                 self.dt)
        return out
