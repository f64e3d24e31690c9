"""Find a cell's parts by the names ``BENCHMARK.json`` gives.

- configuration: the file its entry names (``configs/<config>.json``);
- traffic mix: ``traffic/<traffic>.json``;
- loop: ``loops/<traffic's loop>.py``;
- application: ``apps/<configuration's app>.py``;
- per-layer metric: ``metrics/<metric>.py``, a ``read(obs)`` function; a
  metric split by the end-to-end metric it moves (``idle_share.served``)
  falls back on the reader of the whole name's first part
  (``metrics/idle_share.py``) where it has no file of its own.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; no file here names them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as module ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as run
    traffic: dict           # the traffic file
    end_to_end: list        # entries of BENCHMARK.json this cell reports
    per_layer: list
    root: Path              # the folder that holds this benchmark

    def app(self) -> ModuleType:
        return load_module(self.root / "apps" / f"{self.config['app']}.py",
                           f"portbench_app_{self.config['app']}")

    def loop(self) -> ModuleType:
        return load_module(self.root / "loops" / f"{self.traffic['loop']}.py",
                           f"portbench_loop_{self.traffic['loop']}")

    def metric_reader(self, name: str) -> ModuleType:
        path = self.root / "metrics" / f"{name}.py"
        if not path.is_file():
            path = self.root / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, f"portbench_metric_{name.replace('.', '_')}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark: Path, workload: str, root: Path = BENCH) -> Cell:
    """The cell ``workload`` of the benchmark file ``benchmark``; file
    paths in it are relative to the file's folder."""
    spec = json.loads(benchmark.read_text())
    base = benchmark.parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((base / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in names and _reports(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer, root)
