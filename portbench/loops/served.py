"""One tenant of ``repro_torch.core.ServingRuntime(nodes, devices)`` whose
client advances its simulation ``steps_per_window`` steps a window and
waits for each window before it submits the next (a closed loop of one
client: a user who steers a persistent simulation step by step).

Set-up: the tenant's first window, whose state starts the check, then
``warmup_windows`` more, so that the memo has captured the window and
replays it.  Window: each window is timed from the submission of its steps
to the return of ``WindowHandle.wait()``; windows follow each other until
``seconds`` have passed.  After the window closes, the state is read, one
more window runs through the same tenant (a replay like the timed ones),
and the state it leaves ends the check: reading the state inside the window
would change the tenant's window sequence and so what the memo replays.
"""

from __future__ import annotations

import functools
import time

from portbench.harness.common import Observation, peak_bytes, span


def counters(srv) -> dict:
    m = srv.memo_stats()
    patch = m["patch_us"] or {"count": 0, "sum_us": 0.0}
    return {"memo_hits": m["hits"], "memo_misses": m["misses"],
            "patch_count": patch["count"], "patch_sum_us": patch["sum_us"]}


def run(app, obs: Observation, seconds: float, profiler, device,
        t_start: float) -> dict:
    from repro_torch.core import ServingRuntime
    tr = obs.traffic
    sp = functools.partial(span, on=profiler is not None)
    per = int(tr["steps_per_window"])
    srv = ServingRuntime(int(tr["nodes"]), int(tr["devices"]), device=device)
    try:
        t = srv.tenant(obs.config["app"])
        prog = app.build(t)

        def window():
            app.advance(prog, per)
            t.run().wait()

        window()
        start = app.state(prog) if app.checks_start else None
        for _ in range(int(tr["warmup_windows"])):
            window()
        done = per * (1 + int(tr["warmup_windows"]))
        before = counters(srv)
        lat = []
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        obs.setup_s = t0 - t_start
        with sp("window"):
            while time.perf_counter() - t0 < seconds:
                tw = time.perf_counter()
                with sp("client.submit"):
                    app.advance(prog, per)
                with sp("client.run"):
                    handle = t.run()
                with sp("client.wait"):
                    handle.wait()
                lat.append(time.perf_counter() - tw)
        t1 = time.perf_counter()
        if profiler is not None:
            profiler.stop()
        obs.window_s, obs.units, obs.latencies_s = t1 - t0, len(lat), lat
        after = counters(srv)
        obs.counters = {k: after[k] - before[k] for k in after}
        obs.peak_bytes = peak_bytes(device)
        before_last = app.state(prog)
        window()
        final = app.state(prog)
    finally:
        srv.shutdown()
    return {"start": start, "before": before_last, "final": final,
            "steps": done + per * (len(lat) + 1)}
