"""A simulation on ``repro_torch.core.Runtime(nodes, devices)``.

Set-up: build the program, run its first step and read the state it left
(the start of the check), then ``warmup_steps`` more steps and one state
snapshot, so that every shape the window uses has run.  Window: steps are
submitted ahead in batches of ``batch_steps``, as a simulation submits
them (the main thread records, the schedulers lower, the executors issue
eagerly), with the main thread held while the schedulers have more than
``ahead_batches`` batches waiting.  Once ``seconds`` have passed, a host
task snapshots the state and one more step follows; ``rt.sync()`` closes
the window, and its end counts.  ``step_ms`` is the window over the steps
completed in it.
"""

from __future__ import annotations

import functools
import time

from portbench.harness.common import (Observation, peak_bytes, span,
                                      wait_for_room)


def counters(rt) -> dict:
    return {"instructions": rt.total_instructions(),
            "comm_bytes": rt.comm_stats()["bytes"]}


def run(app, obs: Observation, seconds: float, profiler, device,
        t_start: float) -> dict:
    """Run the cell; fill ``obs``; return the states the check compares."""
    from repro_torch.core import Runtime
    tr = obs.traffic
    sp = functools.partial(span, on=profiler is not None)
    batch = int(tr["batch_steps"])
    room = int(tr["ahead_batches"]) * batch * app.tasks_per_step
    rt = Runtime(int(tr["nodes"]), int(tr["devices"]), device=device)
    try:
        prog = app.build(rt)
        app.advance(prog, 1)
        rt.sync()
        start = app.state(prog) if app.checks_start else None
        app.advance(prog, int(tr["warmup_steps"]))
        app.snapshot_task(prog, rt)
        rt.sync()
        done = 1 + int(tr["warmup_steps"])
        before = counters(rt)
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        obs.setup_s = t0 - t_start
        steps = 0
        with sp("window"):
            while time.perf_counter() - t0 < seconds:
                with sp("submit"):
                    app.advance(prog, batch)
                steps += batch
                with sp("backpressure"):
                    wait_for_room(rt, room)
            with sp("submit"):
                snap = app.snapshot_task(prog, rt)
                app.advance(prog, 1)
            steps += 1
            with sp("sync"):
                rt.sync()
        t1 = time.perf_counter()
        if profiler is not None:
            profiler.stop()
        obs.window_s, obs.units = t1 - t0, steps
        after = counters(rt)
        obs.counters = {k: after[k] - before[k] for k in after}
        obs.peak_bytes = peak_bytes(device)
        final = app.state(prog)
        warnings = list(rt.warnings)
    finally:
        rt.shutdown()
    if warnings:
        raise RuntimeError(f"runtime warnings: {warnings[:3]}")
    return {"start": start, "before": snap, "final": final,
            "steps": done + steps}

