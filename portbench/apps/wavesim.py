"""WaveSim (``repro_torch.apps.WaveSim``) as a benchmark program.

Input from the seed: one standard-normal float32 field, drawn on the run's
device by a ``torch.Generator`` and copied to the host once, since the
application takes numpy initial data.  It is both the previous and the
current field (the wave starts at rest), so the host holds one copy of the
benchmark's own.  A step is one B2 launch per device.

What is compared (``check``): ``field_gap``, the largest gap between the
program's field after all its steps and the reference's, on ``P x P``
patches drawn from the seed, over the root mean square of the reference's
patches.  The reference works each patch out from the seed's field over
every step the program ran (set-up and window), so the check covers the
window's steps themselves.  The patches are the two corners where the
border meets (rows 0 and H - 1), and one patch in each of ``bands`` row
bands between them, at a column drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import no_tf32
from portbench.reference import wavesim as ref

CHECKS = ("field_gap",)


class App:
    checks_start = False      # the check reads the state after step 1
    # the reference in the program's place with each step's field held in
    # bfloat16
    CONTROLS = ("bf16_state",)
    tasks_per_step = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = config, seed
        self.device = torch.device(device)
        self.H, self.W = int(config["height"]), int(config["width"])
        self.c = float(config["c"])
        g = torch.Generator(device=self.device).manual_seed(seed)
        field = torch.randn((self.H, self.W), generator=g,
                            device=self.device, dtype=torch.float32)
        self.u0 = field.cpu().numpy()
        del field
        P, bands = int(config["patch"]), int(config["bands"])
        rng = np.random.default_rng(seed)
        self.corners = [(0, 0), (self.H - P, self.W - P)]
        for b in range(bands):
            lo, hi = b * self.H // bands, (b + 1) * self.H // bands - P
            self.corners.append((int(rng.integers(lo, hi + 1)),
                                 int(rng.integers(0, self.W - P + 1))))

    def build(self, rt):
        from repro_torch.apps import WaveSim
        return WaveSim(rt, self.u0, self.u0, self.c)

    def advance(self, prog, steps: int) -> None:
        prog.advance(steps)

    def state(self, prog) -> dict:
        return {"u": prog.gather()}

    def snapshot_task(self, prog, rt):
        return None

    def check(self, start, before, final: dict, steps: int,
              control: str | None = None) -> dict:
        """The compared number of a run; with ``control`` (``bf16_state``)
        the reference's patches with every step rounded to bfloat16 stand
        in for the program's."""
        P = int(self.cfg["patch"])
        with no_tf32():
            want = ref.patches(self.u0, self.u0, self.corners, P, steps,
                               self.c, device=self.device)
            if control is None:
                u = final["u"]
                got = torch.from_numpy(np.stack(
                    [u[r:r + P, q:q + P] for r, q in self.corners]))
            else:
                got = ref.patches(self.u0, self.u0, self.corners, P, steps,
                                  self.c, device=self.device,
                                  store=torch.bfloat16)
        got = got.to(want.device, torch.float32)
        scale = want.double().pow(2).mean().sqrt()
        gap = (got.double() - want.double()).abs().max() / scale
        return {"field_gap": float(gap)}
