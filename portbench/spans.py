"""Run one cell once, traced, with the runtime's own spans on or off, and
print one JSON line: the cell's metrics, and with the spans on, what they
read (``harness/program.py``).

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s> --spans <0|1> [--check 1]

The run is the cell's traced run (``run.py --trace 1``), but the cell's
loop builds its runtime with ``trace="spans"`` where ``--spans 1``.  The
line holds every metric of the cell, end to end and per layer, so that
runs with the spans on and off compare; ``clock_offset_us``, the
converted tracer time of the window's start less the profiler's
``portbench.window`` start, and ``clock_probes_us``, the same for 20
spans of a second profiler session after the run; ``idle_by_program``
and ``longest_gaps``, the cards' idle time by runtime span; and with
``--check 1`` the compared numbers of ``correct``.
"""

import argparse
import json
import sys
import time

T_START = time.perf_counter()


def traced_run(cell, seed: int, seconds: float, spans: bool, check: bool,
               device) -> dict:
    import repro_torch.core as core
    from portbench.harness import program
    from portbench.harness import trace as tracing
    from portbench.harness.common import Observation
    built = []

    def with_spans(cls):
        def build(*args, **kw):
            rt = cls(*args, **kw, **({"trace": "spans"} if spans else {}))
            built.append(rt)
            return rt
        return build

    # The loops take ``Runtime`` and ``ServingRuntime`` from
    # ``repro_torch.core`` inside ``run()``, so swapping the module's
    # attributes here reaches them; a loop that imported them at module
    # level would build its runtime without the spans, and this run would
    # read none.
    runtime, serving = core.Runtime, core.ServingRuntime
    core.Runtime, core.ServingRuntime = with_spans(runtime), \
        with_spans(serving)
    try:
        app = cell.app().App(cell.config, cell.traffic, seed, device)
        obs = Observation(cell.name, cell.config, cell.traffic,
                          cards=cell.chips)
        prof = tracing.profiler()
        states = cell.loop().run(app, obs, seconds, prof, device, T_START)
    finally:
        core.Runtime, core.ServingRuntime = runtime, serving
    obs.timeline, base_ns = program.read_trace(prof, list(range(cell.chips)))
    del prof
    tl = obs.timeline
    out = {"workload": cell.name, "seed": seed, "spans": spans,
           "metrics": {}, "window_s": obs.window_s, "units": obs.units}
    for m in cell.end_to_end + cell.per_layer:
        value = cell.metric_reader(m["name"]).read(obs)
        if value is not None:
            out["metrics"][m["name"]] = value
    tracer = built[0].tracer if built else None
    ps = program.program_spans(tracer, base_ns, tl.window)
    if ps:
        t0 = T_START + obs.setup_s - tracer.epoch   # the loop's window start
        out["clock_offset_us"] = tracer.unix_us(t0, base_ns) - tl.window[0]
        out["clock_probes_us"] = program.clock_probes(tracer)
        steps = cell.traffic["loop"] == "steps"
        out["program"] = {
            "lower_us_per_step": program.lower_us_per_step(
                ps, tl.window, obs.units) if steps else None,
            "launch_us_p50": program.median_us(ps, tl.window, "lane.launch"),
            "wake_us_p50": program.median_us(ps, tl.window, "exec.wake"),
            "window_wake_us_p50": program.window_wake_us_p50(ps, tl.window),
            "idle_traced_share": program.idle_traced_share(tl, ps)}
        out["idle_by_program"] = program.idle_by_program(tl, ps)
        out["longest_gaps"] = program.longest_gaps(tl, ps)
        out["gc_in_window"] = {
            g: sum(1 for n, *_ in ps if n == g)
            for g in ("gc.gen0", "gc.gen1", "gc.gen2")}
    out["idle_gaps"] = tl.breakdown()["idle_gaps"]
    if check:
        out["checks"] = app.check(states["start"], states["before"],
                                  states["final"], states["steps"])
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), required=True)
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench.harness.spec import BENCH, load_cell
    cell = load_cell(BENCH.parent / "BENCHMARK.json", args.workload)
    print(json.dumps(traced_run(cell, args.seed, args.seconds,
                                bool(args.spans), bool(args.check),
                                args.device)), flush=True)
    return 0


if __name__ == "__main__":
    import run  # noqa: F401  the caches, environment and path of a run
    sys.exit(main(sys.argv[1:]))
