"""Training through ``repro_torch.runtime.TrainLoop`` (prefetch and step as
host tasks on ``core.Runtime``), from the application's model and batches.

Set-up: the loop and its state, the first step with the gradient set's
gradients copied as the backward makes them and the set's weights copied
after the update (the check's start, moved to the host), and the rest of
the traffic's ``warmup_steps``, whose mean time sets how many steps fill
``seconds`` (rounded up).  Window: those steps in one ``TrainLoop.run``,
which returns once it has read the last step's loss.  ``step_ms`` is the
window over its steps; the card's peak memory is the window's (the
counter is reset as it opens).  ``counters``: B3's and B4's launches and
the MoE's assignments per held expert, to experts held elsewhere and
dropped, over the window.
"""

from __future__ import annotations

import functools
import math
import time

from portbench.harness.common import Observation, peak_bytes, span


def counters() -> dict:
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import layers
    return {"b3_launches": flash_attention.launches,
            "b4_launches": ssd_scan.launches,
            "expert_assignments": dict(layers.moe_dropless.assigned),
            "absent_assignments": layers.moe_dropless.absent,
            "dropped_assignments": layers.moe_dropless.dropped}


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {e: c - before[k].get(e, 0) for e, c in v.items()}
        else:
            out[k] = v - before[k]
    return out


def run(app, obs: Observation, seconds: float, profiler, device,
        t_start: float) -> dict:
    """Run the cell; fill ``obs``; return the states the check compares."""
    import torch
    from repro_torch.runtime import TrainLoop
    tr = obs.traffic
    sp = functools.partial(span, on=profiler is not None)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    loop = TrainLoop(app.arch, global_batch=app.batch, seq_len=app.seq_len,
                     lr=float(tr["lr"]), ckpt_dir=tr["checkpoint_dir"],
                     prefetch_depth=int(tr["prefetch_depth"]),
                     seed=app.seed, device=device, init=app.build)
    first = counters()
    state = loop.init_state()
    grads, hooks = app.capture_grads(loop.model)
    t, state, metrics = loop.run(1, start_step=0, state=state)
    for h in hooks:
        h.remove()
    updated = app.leaves(dict(loop.model.named_parameters()))
    start = {"grads": {k: g.cpu() for k, g in grads.items()},
             "updated": {k: w.detach().to("cpu", copy=True)
                         for k, w in updated.items()},
             "grad_norm": metrics.grad_norms[0]}
    del grads, updated
    warm = int(tr["warmup_steps"]) - 1
    t0 = time.perf_counter()
    t, state, _ = loop.run(warm, start_step=t, state=state)
    sync()
    n = max(2, math.ceil(seconds * warm / (time.perf_counter() - t0)))

    before = counters()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    obs.setup_s = t0 - t_start
    with sp("window"):
        with sp("steps"):
            t, state, metrics = loop.run(n, start_step=t, state=state)
    t1 = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    obs.window_s, obs.units = t1 - t0, n
    after = counters()
    obs.counters = delta(after, before)
    obs.peak_bytes = peak_bytes(device)
    final = {"loss": metrics.losses[-1],
             "dropped": after["dropped_assignments"]
             - first["dropped_assignments"]}
    return {"start": start, "before": None, "final": final, "steps": t}
