"""A configuration, a traffic mix and a per-layer metric added as files, in
a copy of the benchmark, are found by name with no other file edited."""

import json
import shutil
from pathlib import Path

from portbench.harness.common import Observation
from portbench.harness.main import run_cell
from portbench.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]


def test_added_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "nbody-2p19.json").read_text())
    cfg.update(name="nbody-tiny", bodies=256)
    (bench / "configs" / "nbody-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "1x2.steps.json").write_text(json.dumps(
        {"loop": "steps", "nodes": 1, "devices": 2, "batch_steps": 2,
         "ahead_batches": 1, "warmup_steps": 1}))
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(obs):\n    return float(obs.units)\n")
    spec["configs"].append({"name": "nbody-tiny", "source": "test",
                            "file": "portbench/configs/nbody-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "nbody-tiny.1x2.steps",
                              "config": "nbody-tiny", "traffic": "1x2.steps",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_done", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "Program", "moves": "step_ms",
                              "workloads": ["nbody-tiny.1x2.steps"]})
    for m in spec["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("nbody-tiny.1x2.steps")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell(tmp_path / "BENCHMARK.json", "nbody-tiny.1x2.steps",
                     root=bench)
    assert cell.config["bodies"] == 256 and cell.traffic["devices"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["step_ms", "setup_s"]
    assert "steps_done" in [m["name"] for m in cell.per_layer]
    obs = Observation(cell.name, cell.config, cell.traffic, cards=1, units=7)
    assert cell.metric_reader("steps_done").read(obs) == 7.0
    # a metric split by what it moves reads through its first part's file
    split = cell.metric_reader("steps_done.served")
    assert split.read(obs) == 7.0 and split.__file__.endswith("steps_done.py")
    result = run_cell(cell, 5, 0.2, False, "cpu", 0.0)
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"step_ms", "setup_s"}
