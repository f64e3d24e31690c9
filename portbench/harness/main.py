"""Run one cell once and build its result line."""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys

from portbench.harness import trace as tracing
from portbench.harness.common import Observation
from portbench.harness.spec import BENCH, Cell, load_cell

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def observe(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float):
    """Run ``cell``'s loop once; return the application, what the run saw
    and the states its check compares.  The program's state is freed."""
    import torch
    app = cell.app().App(cell.config, cell.traffic, seed, device)
    obs = Observation(cell.name, cell.config, cell.traffic, cards=cell.chips)
    prof = tracing.profiler() if trace else None
    states = cell.loop().run(app, obs, seconds, prof, device, t_start)
    if prof is not None:
        obs.timeline = tracing.read(prof, list(range(cell.chips)))
        del prof
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return app, obs, states


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run ``cell`` once on ``device``; return its result (the line's
    object, with the compared numbers under ``checks``, last)."""
    app, obs, states = observe(cell, seed, seconds, trace, device, t_start)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    values = app.check(states["start"], states["before"], states["final"],
                       states["steps"])
    limits = cell.config["limits"]
    # a number that is not finite fails, and is printed as null
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in values.items())
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": limits[k]} for k, v in values.items()}
    result = {"correct": bool(correct), "attempted": obs.units, "failed": 0,
              "metrics": metrics, "device": device_info(cell, obs, device)}
    if obs.timeline is not None:
        result["breakdown"] = obs.timeline.breakdown()
    result["checks"] = checks
    return result


def device_info(cell: Cell, obs: Observation, device) -> dict:
    import torch
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": obs.peak_bytes}
    if obs.timeline is not None:
        info["busy_s"] = obs.timeline.busy_s()
        info["window_s"] = obs.timeline.window_s
    if cuda:
        info["power_limit_w"] = power_limit()
    return info


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return ",".join(out.stdout.split("\n")[:1]).strip() or "not read"


def report(result: dict) -> None:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(BENCH.parent / "BENCHMARK.json", args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        print("portbench: a metric is not finite", file=sys.stderr)
        return 4
    report(result)
    return 0

