"""Readings that set the limits of ``correct``, kept apart from the
benchmark's runs, which never run it.

For each seed, in one process: one run of the cell's loop at the cell's
own size and load, then its compared numbers from the program's states,
and again with each of the application's controls in the program's place:
the reference computed in bfloat16, the nearest precision below the
configuration's float32 that changes these programs (neither computes a
matrix product, so TF32 changes nothing).  One JSON line per seed.

    python3 portbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--controls <name> ...]
"""

import argparse
import json
import sys
import time


def readings(cell, seed: int, seconds: float, device,
             controls=None) -> dict:
    """The program's compared numbers and each control's (all of the
    application's, or those named in ``controls``) for one seed."""
    from portbench.harness.main import observe
    t0 = time.perf_counter()
    app, obs, states = observe(cell, seed, seconds, False, device, t0)
    args = (states["start"], states["before"], states["final"],
            states["steps"])
    t1 = time.perf_counter()
    program = app.check(*args)
    t2 = time.perf_counter()
    control = {name: app.check(*args, control=name)
               for name in (controls or app.CONTROLS)}
    return {"seed": seed, "steps": states["steps"], "units": obs.units,
            "window_s": obs.window_s, "setup_s": obs.setup_s,
            "check_s": t2 - t1, "control_s": time.perf_counter() - t2,
            "program": program, "control": control}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="the controls to read; all of the app's if not given")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench.harness.spec import BENCH, load_cell
    cell = load_cell(BENCH.parent / "BENCHMARK.json", args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.device,
                                  args.controls)),
              flush=True)
    return 0


if __name__ == "__main__":
    import run  # noqa: F401  the caches, environment and path of a run
    sys.exit(main(sys.argv[1:]))
