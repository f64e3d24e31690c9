"""Each control, the reference computed in bfloat16 in the program's
place, fails at least one of its cell's limits, and the program passes
them all, at a size a test run holds (on the card: ``gpu``)."""

import sys
from pathlib import Path

import pytest
import torch

from portbench.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "portbench"))
from control import readings  # noqa: E402

SIZES = {"nbody-2p19": {"bodies": 1024},
         "wavesim-32768": {"height": 256, "width": 224}}
WORKLOADS = ["nbody-2p19.2x2.steps", "wavesim-32768.1x1.steps",
             "nbody-2p19.2x2.served"]


def control_case(workload, device, seeds, seconds):
    cell = load_cell(ROOT / "BENCHMARK.json", workload)
    cell.config.update(SIZES[cell.config["name"]])
    limits = cell.config["limits"]
    for seed in seeds:
        r = readings(cell, seed, seconds, device)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert set(r["control"]) == set(cell.app().App.CONTROLS), r
        for control in r["control"].values():
            assert any(v > limits[k] for k, v in control.items()), r


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_cpu(workload):
    control_case(workload, "cpu", [3, 2**31 + 5], 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    control_case(workload, "cuda", [3, 11, 2**31 + 5], 2.0)
