"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault its cell can have; the same run unbroken reads true.

The harness's look for a card is skipped: the cells run on the CPU at tiny
sizes, through their own loops, with the program's plain kernels."""

import json
from pathlib import Path

import pytest
import torch

import repro_torch.apps.nbody as nbody_app
import repro_torch.apps.wavesim as wave_app
from repro_torch.core.allocation import is_device_memory
from repro_torch.core.communicator import ReceiveArbiter
from repro_torch.core.executor import Executor
from repro_torch.kernels.nbody import nbody_forces_rows_plain

from portbench.harness.main import run_cell
from portbench.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
TINY = {"nbody-2p19": {"bodies": 512},
        "wavesim-32768": {"height": 192, "width": 160}}


def tiny(workload):
    """The cell at a small size.  ``nbody-2p19.1x4.steps`` is not in
    ``BENCHMARK.json`` (PERF.md, Open questions): it is the 2 x 2 cell with
    the ``1x4.steps`` traffic file, one node of four devices."""
    if workload == "nbody-2p19.1x4.steps":
        cell = load_cell(ROOT / "BENCHMARK.json", "nbody-2p19.2x2.steps")
        cell.traffic = json.loads(
            (ROOT / "portbench" / "traffic" / "1x4.steps.json").read_text())
    else:
        cell = load_cell(ROOT / "BENCHMARK.json", workload)
    cell.config.update(TINY[cell.config["name"]])
    return cell


# -- faults of the N-body ------------------------------------------------
def unchanged(mp):
    """A step that returns its state unchanged."""
    mp.setattr(nbody_app.NBody, "advance", lambda self, steps, **kw: None)


def one_step_unchanged(mp):
    """One step inside the window leaves the state unchanged; the first
    step and the last are sound."""
    advance = nbody_app.NBody.advance
    calls = []

    def advance_once_idle(self, steps, **kw):
        calls.append(steps)
        if len(calls) != 8:            # set-up makes seven calls or fewer
            return advance(self, steps, **kw)
        work = self._timestep, self._update
        self._timestep = self._update = lambda *args: None
        try:
            advance(self, 1, **kw)
        finally:
            self._timestep, self._update = work
        if steps > 1:
            advance(self, steps - 1, **kw)
    mp.setattr(nbody_app.NBody, "advance", advance_once_idle)


def half_the_bodies(mp):
    """Half the bodies left out of each sum, the rest counted double."""
    def forces(p_all, lo, hi, soft=1e-3):
        pa = p_all.to(torch.float32)
        d = pa[None, ::2, :] - pa[lo:hi, None, :]
        w = ((d * d).sum(-1) + soft).rsqrt() ** 3
        return (2 * (d * w[..., None]).sum(1)).to(p_all.dtype)
    mp.setattr(nbody_app, "nbody_forces_rows", forces)


def no_exchange(mp):
    """The rows other nodes send never land."""
    put = ReceiveArbiter._put

    def drop(self, dst, data):
        if isinstance(dst, torch.Tensor):
            return
        put(self, dst, data)
    mp.setattr(ReceiveArbiter, "_put", drop)


def no_peer_copy(mp):
    """The copies between the devices of a node are left out."""
    copy = Executor._exec_copy

    def skip(self, instr):
        if not (is_device_memory(instr.src_alloc.mid)
                and is_device_memory(instr.dst_alloc.mid)):
            copy(self, instr)
    mp.setattr(Executor, "_exec_copy", skip)


def altered_force(mp):
    """One answer of each launch altered where it is produced."""
    def forces(p_all, lo, hi, soft=1e-3):
        out = nbody_forces_rows_plain(p_all, lo, hi, soft)
        out[0] = -out[0]
        return out
    mp.setattr(nbody_app, "nbody_forces_rows", forces)


# -- faults of WaveSim ---------------------------------------------------
def wave_unchanged(mp):
    """A step that returns the current field unchanged."""
    def step(um_chunk, u_ext, row0, H, c=0.25):
        top = int(row0 > 0)
        return u_ext[top:top + um_chunk.shape[0]].clone()
    mp.setattr(wave_app, "wave_step_rows", step)


def wave_half_rows(mp):
    """Half of the rows left out of each step."""
    step0 = wave_app.wave_step_rows

    def step(um_chunk, u_ext, row0, H, c=0.25):
        out = step0(um_chunk, u_ext, row0, H, c)
        out[out.shape[0] // 2:] = 0
        return out
    mp.setattr(wave_app, "wave_step_rows", step)


def wave_altered(mp):
    """Every cell of a step's answer altered where it is produced."""
    step0 = wave_app.wave_step_rows

    def step(um_chunk, u_ext, row0, H, c=0.25):
        return step0(um_chunk, u_ext, row0, H, c) + 1e-3
    mp.setattr(wave_app, "wave_step_rows", step)


NBODY_FAULTS = [None, unchanged, one_step_unchanged, half_the_bodies,
                no_exchange, altered_force]
CASES = ([("nbody-2p19.2x2.steps", f) for f in NBODY_FAULTS]
         + [("nbody-2p19.2x2.served", f) for f in NBODY_FAULTS]
         + [("nbody-2p19.1x4.steps", f) for f in
            (None, unchanged, one_step_unchanged, half_the_bodies,
             no_peer_copy, altered_force)]
         + [("wavesim-32768.1x1.steps", f)
            for f in (None, wave_unchanged, wave_half_rows, wave_altered)])


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}"
                              for w, f in CASES])
def test_fault_reads_not_correct(monkeypatch, workload, fault):
    cell = tiny(workload)
    if fault is not None:
        fault(monkeypatch)
    result = run_cell(cell, 2**31 + 77, 0.3, False, "cpu", 0.0)
    assert result["correct"] is (fault is None), result["checks"]
