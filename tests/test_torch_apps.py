"""The port's main-path programs held against ``examples/nbody.py``,
``examples/wavesim.py`` and ``examples/rsim_lookahead.py``.

Each program runs on the port's runtime on the CPU (``device="cpu"``) and its
counterpart, built from the example's own kernels, on ``repro.core``.  The
lowering is a copy, so instruction counts, allocation counts and
``comm_stats()`` must be equal.  Values: the exact-sum reductions are
bit-identical across grids within the port and equal ``math.fsum`` of the
port's own contributions; the port's forces (kernel B1's plain version, f32
arithmetic) and wave steps (B2's, f32) differ from the examples' float64
numpy closures, so the reference's energies are taken on the port's own
state.
"""

import contextlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Runtime as RefRuntime
from repro.core import (all_range, neighborhood, one_to_one, read,
                        read_write, reduction, write)
from repro.core.collective import allreduce_message_count
from repro.core.region import Box
from repro_torch.apps import (NBody, WaveSim, body_energies, run_rsim,
                              serve_simulations)
from repro_torch.apps import nbody as port_nbody
from repro_torch.apps import wavesim as port_wavesim
from repro_torch.core import Box as PortBox
from repro_torch.core import Runtime, ServingRuntime
from repro_torch.core.executor import BufferView
from repro_torch.core.allocation import Allocation
from repro_torch.kernels.stencil5 import wave_step_rows
from torch_parity import keep_reference_ids  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
QUIET = dict(retransmit_timeout=60.0)
# examples/nbody.py
N, STEPS, DT, MASS, ENERGY_EVERY = 512, 8, 0.01, 1.0, 4
ENERGY_GRIDS = [(1, 1, True), (2, 2, True), (3, 1, True), (2, 2, False)]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX_NBODY = _example("nbody")
EX_WAVE = _example("wavesim")
EX_RSIM = _example("rsim_lookahead")


def _structure(rt):
    return dict(instructions=rt.total_instructions(),
                allocs=rt.total_allocs(), comm=rt.comm_stats(),
                live=[r["real_used"] for r in rt.memory_report()])


def _bodies(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1


# -- N-body energy and momentum (examples/nbody.py main) -------------------------------
def _ref_sim(q, P0, V0, suffix=""):
    """``examples/nbody.py``'s buffers and kernels on the reference runtime."""
    n = P0.shape[0]
    P = q.buffer((n, 3), init=P0, name=f"P{suffix}")
    V = q.buffer((n, 3), init=V0, name=f"V{suffix}")
    E = q.buffer((1,), init=np.zeros(1), name=f"E{suffix}")
    Mx = q.buffer((1,), init=np.zeros(1), name=f"Mx{suffix}")

    def timestep(chunk, p, v):
        Pa = p.get(Box((0, 0), (n, 3)))
        lo, hi = chunk.min[0], chunk.max[0]
        d = Pa[None, :, :] - Pa[lo:hi, None, :]
        r2 = (d * d).sum(-1) + EX_NBODY.EPS
        v.set(chunk, v.get(chunk) + MASS * (d / r2[..., None] ** 1.5).sum(1) * DT)

    def update(chunk, v, p):
        p.set(chunk, p.get(chunk) + v.get(chunk) * DT)

    def energy(chunk, p, v, red):
        Pa = p.get(Box((0, 0), (n, 3)))
        lo, hi = chunk.min[0], chunk.max[0]
        red.contribute(EX_NBODY.body_energies(Pa, v.get(chunk), lo, hi))

    def momentum(chunk, v, red):
        red.contribute(MASS * v.get(chunk)[:, 0])

    def steps(k):
        for _ in range(k):
            q.submit("timestep", (n, 3),
                     [read(P, all_range()), read_write(V, one_to_one())],
                     timestep)
            q.submit("update", (n, 3),
                     [read(V, one_to_one()), read_write(P, one_to_one())],
                     update)

    def measure(with_momentum=True):
        q.submit("energy", (n, 3), [read(P, all_range()), read(V, one_to_one()),
                                    reduction(E, "sum")], energy)
        if with_momentum:
            q.submit("momentum", (n, 3),
                     [read(V, one_to_one()), reduction(Mx, "sum")], momentum)
    return (P, V, E, Mx), steps, measure


def _port_energy(nodes, devices, fusion):
    P0, V0 = _bodies(N, 42)
    with Runtime(nodes, devices, device="cpu", reduction_fusion=fusion,
                 **QUIET) as rt:
        sim = NBody(rt, P0, V0, DT, MASS)
        sim.advance(STEPS, energy_every=ENERGY_EVERY)
        e, mx = sim.energy()
        out = dict(E=e, Mx=mx, P=sim.gather(), V=sim.gather_velocities(),
                   structure=_structure(rt))
        assert rt.warnings == [], rt.warnings
    return out


@pytest.fixture(scope="module")
def energy_runs():
    return {g: _port_energy(*g) for g in ENERGY_GRIDS}


@pytest.mark.parametrize("grid", ENERGY_GRIDS)
def test_energy_structure_equals_reference(energy_runs, grid):
    nodes, devices, fusion = grid
    P0, V0 = _bodies(N, 42)
    with RefRuntime(nodes, devices, reduction_fusion=fusion, **QUIET) as q:
        bufs, steps, measure = _ref_sim(q, P0, V0)
        for _ in range(STEPS // ENERGY_EVERY):
            steps(ENERGY_EVERY)
            measure()
        P, V, E, Mx = bufs
        for b in (E, Mx, P, V):        # what the port's run gathers
            q.gather(b)
        ref_s = _structure(q)
    assert energy_runs[grid]["structure"]["instructions"] > 0
    port_s = dict(energy_runs[grid]["structure"])
    assert port_s == ref_s


def test_energy_bit_identical_across_grids(energy_runs):
    runs = list(energy_runs.values())
    for r in runs[1:]:
        assert (r["E"], r["Mx"]) == (runs[0]["E"], runs[0]["Mx"])
        np.testing.assert_array_equal(r["P"], runs[0]["P"])
        np.testing.assert_array_equal(r["V"], runs[0]["V"])


def test_energy_equals_fsum_of_body_energies(energy_runs):
    """E is ``math.fsum`` of the port's per-body energies on its gathered
    state, and of the reference's ``body_energies`` on the same state, bit
    for bit (the port computes them in numpy's order); Mx is ``math.fsum``
    of the momenta."""
    r = energy_runs[(2, 2, True)]
    P, V = r["P"], r["V"]
    port = body_energies(torch.from_numpy(P), torch.from_numpy(V), 0, N,
                         MASS).numpy()
    ref = EX_NBODY.body_energies(P, V, 0, N)
    np.testing.assert_array_equal(port, ref)
    assert r["E"] == math.fsum(port) == math.fsum(ref)
    assert r["Mx"] == math.fsum(MASS * V[:, 0])


@pytest.mark.parametrize("grid", [g for g in ENERGY_GRIDS if g[0] > 1])
def test_energy_exchange_count(energy_runs, grid):
    """Fused: one exchange per energy step; unfused: two (E and Mx)."""
    nodes, _, fusion = grid
    group = tuple(range(nodes))
    per_exchange = allreduce_message_count(group, group, 1)
    msgs = energy_runs[grid]["structure"]["comm"]["red_messages"]
    want = STEPS // ENERGY_EVERY * (1 if fusion else 2)
    assert msgs == want * per_exchange


@pytest.mark.parametrize("N_,lo,hi", [(48, 0, 48), (48, 5, 17), (300, 299, 300),
                                      (9000, 4000, 4003)])
def test_body_energies_equal_reference_rows(N_, lo, hi):
    P, V = _bodies(N_, N_)
    got = body_energies(torch.from_numpy(P), torch.from_numpy(V[lo:hi]), lo,
                        hi, MASS).numpy()
    np.testing.assert_array_equal(got, EX_NBODY.body_energies(P, V[lo:hi],
                                                              lo, hi))


@pytest.mark.parametrize("n", [5, 8, 100, 128, 129, 300, 4096, 8193, 20000,
                               1 << 15])
def test_pairwise_sum_is_numpys(n):
    a = np.random.default_rng(n).normal(size=(3, n))
    np.testing.assert_array_equal(port_nbody.pairwise_sum(torch.from_numpy(a)),
                                  a.sum(1))


# -- WaveSim residual (examples/wavesim.py main) ---------------------------------------
H, W, WAVE_STEPS = 256, 128, 20


def _splash():
    u1 = np.zeros((H, W))
    u1[H // 2 - 4:H // 2 + 4, W // 2 - 4:W // 2 + 4] = 1.0
    return u1.copy(), u1


def _ref_wave(q, u0, u1, steps, suffix=""):
    h, w = u1.shape
    step_kernel = EX_WAVE._make_step_kernel(h, w)
    B = [q.buffer((h, w), init=u0, name=f"um{suffix}"),
         q.buffer((h, w), init=u1, name=f"u{suffix}"),
         q.buffer((h, w), init=np.zeros((h, w)), name=f"un{suffix}")]
    R2 = q.buffer((1,), init=np.zeros(1), name=f"R2{suffix}")

    def run(lo, hi):
        for s in range(lo, hi):
            um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
            q.submit(f"wave{s}", (h, w),
                     [read(um, one_to_one()), read(u, neighborhood((1, 0))),
                      write(un, one_to_one())], step_kernel)

    def residual():
        q.submit("residual", (h, w),
                 [read(B[steps % 3], one_to_one()),
                  read(B[(steps + 1) % 3], one_to_one()),
                  reduction(R2, "sum")], EX_WAVE.residual)
    return B, R2, run, residual


@pytest.mark.parametrize("nodes,devices", [(1, 1), (2, 2), (4, 1)])
def test_wave_residual(nodes, devices):
    """The residual equals ``math.fsum`` of the port's own fields bit for bit;
    the structure equals the reference program's; the value is within 1e-6
    of the reference example's.  The fields agree to 1e-4 (B2 steps in
    f32), and the residual sums 32768 squares of their difference, whose
    relative error is then that of the fields' last steps."""
    u0, u1 = _splash()
    with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
        sim = WaveSim(rt, u0, u1)
        sim.advance(WAVE_STEPS)
        sim.residual()
        field, prev = sim.gather(), sim.gather_previous()
        res2 = sim.residual_value()
        port_s = _structure(rt)
    with RefRuntime(nodes, devices, **QUIET) as q:
        B, R2, run, residual = _ref_wave(q, u0, u1, WAVE_STEPS)
        run(0, WAVE_STEPS)
        residual()
        q.gather(B[(WAVE_STEPS + 1) % 3])
        q.gather(B[WAVE_STEPS % 3])
        ref = float(q.gather(R2)[0])
        ref_s = _structure(q)
    assert port_s == ref_s
    assert res2 == math.fsum(((field - prev) ** 2).ravel())
    assert res2 > 0 and abs(res2 - ref) <= 1e-6 * ref


# -- B2 writes each step into the new field's allocation -------------------------------
@pytest.mark.parametrize("nodes,devices", [(1, 1), (2, 2)])
def test_wave_steps_write_into_the_field(monkeypatch, nodes, devices):
    """Every chunk of every step lands in ``un``'s own allocation
    (``in_place`` grows by one a chunk a step), and the fields and residual
    are bit for bit those of steps stored by ``BufferView.set`` from a fresh
    tensor, the path without the destination."""
    u0, u1 = _splash()

    def run():
        with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
            sim = WaveSim(rt, u0, u1)
            n0 = wave_step_rows.in_place
            sim.advance(WAVE_STEPS)
            sim.residual()
            out = (sim.gather(), sim.gather_previous(), sim.residual_value())
            return out, wave_step_rows.in_place - n0

    (field, prev, res2), n = run()
    assert n == WAVE_STEPS * nodes * devices
    monkeypatch.setattr(port_wavesim, "writing_into",
                        lambda dst: contextlib.nullcontext())
    (field0, prev0, res0), n0 = run()
    assert n0 == 0
    np.testing.assert_array_equal(field, field0)
    np.testing.assert_array_equal(prev, prev0)
    assert res2 == res0


def test_buffer_view_set_with_its_own_view_leaves_the_field():
    """What the step kernel does after B2 wrote in place: ``set`` of a chunk
    with the view ``get`` gave of it, in an allocation that starts at row 2."""
    class _Binding:
        region = None

        class accessor:
            class mode:
                is_producer = True

    t = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    want = t.clone()
    v = BufferView(t, Allocation(mid=2, bid=None, box=PortBox((2, 0), (8, 4))),
                   _Binding, check_bounds=False)
    box = PortBox((3, 0), (6, 4))
    own = v.get(box)
    v.set(box, own)
    assert own.data_ptr() == t[1:4].data_ptr()
    assert torch.equal(t, want)


@pytest.mark.parametrize("wait,depth", [(True, 1), (False, 2)])
def test_served_wave_tenant_replays_in_place(wait, depth):
    """A WaveSim tenant of ``ServingRuntime(2, 2)``, 40 windows, memo on:
    replayed windows write in place like lowered ones (four chunks a
    window), and the field is that of the runtime-free steps bit for bit."""
    rng = np.random.default_rng(40)
    u0 = rng.standard_normal((64, 32), dtype=np.float32)
    u1 = rng.standard_normal((64, 32), dtype=np.float32)
    n0 = wave_step_rows.in_place
    with ServingRuntime(2, 2, device="cpu", memo=True,
                        max_inflight_windows=depth) as srv:
        out = serve_simulations(srv, u0, u1, None, None, wave_windows=40,
                                nbody_windows=0, dt=1e-3, mass=1.0, wait=wait)
        replayed = srv.tenants["wave"].replayed_windows
    assert replayed > 0
    assert wave_step_rows.in_place - n0 == 40 * 4
    um, u = torch.from_numpy(u0), torch.from_numpy(u1)
    for _ in range(40):
        um, u = u, wave_step_rows(um, u, 0, 64)
    np.testing.assert_array_equal(out["wave"]["field"], u.numpy())


# -- budget demos ----------------------------------------------------------------------
def _budget(run, nodes, devices):
    """``run(rt)`` unbudgeted, then under 50% of its device high-water
    mark; the results and the budgeted run's memory report."""
    with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
        base = run(rt)
        hwm = rt.device_peak_bytes()
        assert rt.warnings == [], rt.warnings
    budget = hwm // 2
    with Runtime(nodes, devices, device="cpu", device_memory_budget=budget,
                 **QUIET) as rt:
        out = run(rt)
        reports = rt.memory_report()
        peak = rt.device_peak_bytes()
        structure = _structure(rt)
        assert rt.warnings == [], rt.warnings
    return base, out, budget, peak, reports, structure


def _counters(reports):
    return {k: sum(r[k] for r in reports)
            for k in ("spills", "reloads", "evictions", "writeback_elisions")}


def test_nbody_budget_demo():
    """examples/nbody.py's budget demo (3 phased simulations, 256 bodies, 8
    steps, 1 x 1): bit for bit equal to unbudgeted, under budget, spills and
    reloads; the same counters and structure as the reference program under
    the same budget."""
    inits = [_bodies(256, 100 + i) for i in range(3)]

    def run(rt):
        return port_nbody.budget_program(rt, inits, 8, DT, MASS)

    base, out, budget, peak, reports, port_s = _budget(run, 1, 1)
    assert out == base and all(np.isfinite(out))
    assert peak <= budget
    counters = _counters(reports)
    assert counters["spills"] > 0 and counters["reloads"] > 0
    with RefRuntime(1, 1, device_memory_budget=budget, **QUIET) as q:
        sims = [_ref_sim(q, P0, V0, str(i)) for i, (P0, V0) in enumerate(inits)]
        sims[0][1](4)
        for _, steps, measure in sims[1:]:
            steps(8)
            measure(with_momentum=False)
        sims[0][1](4)
        sims[0][2](with_momentum=False)
        for (_, _, E, _), _, _ in sims:
            q.gather(E)
        assert _counters(q.memory_report()) == counters
        assert _structure(q) == port_s


def test_wave_budget_demo():
    """examples/wavesim.py's budget demo (3 interleaved 128 x 64 simulations,
    12 steps, 2 x 2): fields and residuals bit for bit equal to unbudgeted,
    each residual the fsum of its fields, under budget, spills and reloads;
    the same counters and structure as the reference program under the same
    budget."""
    def run(rt):
        return port_wavesim.budget_program(rt, 128, 64, 12)

    base, out, budget, peak, reports, port_s = _budget(run, 2, 2)
    for (f_b, p_b, r_b), (f_u, p_u, r_u) in zip(out, base):
        np.testing.assert_array_equal(f_b, f_u)
        np.testing.assert_array_equal(p_b, p_u)
        assert r_b == r_u == math.fsum(((f_b - p_b) ** 2).ravel())
    assert peak <= budget
    counters = _counters(reports)
    assert counters["spills"] > 0 and counters["reloads"] > 0
    with RefRuntime(2, 2, device_memory_budget=budget, **QUIET) as q:
        sims = []
        for i in range(3):
            u1 = np.zeros((128, 64))
            u1[8 + 6 * i:14 + 6 * i, 29:35] = 1.0 + 0.25 * i
            sims.append(_ref_wave(q, u1.copy(), u1, 12, str(i)))
        sims[0][2](0, 6)
        for _, _, run_steps, residual in sims[1:]:
            run_steps(0, 12)
            residual()
        sims[0][2](6, 12)
        sims[0][3]()
        for B, R2, _, _ in sims:
            q.gather(B[13 % 3])
            q.gather(B[12 % 3])
            q.gather(R2)
        assert _counters(q.memory_report()) == counters
        assert _structure(q) == port_s


# -- RSim lookahead (examples/rsim_lookahead.py) -----------------------------------------
def test_rsim_allocations_equal_reference():
    on, allocs_on, stats = run_rsim(64, 4096, lookahead=True, device="cpu")
    off, allocs_off, _ = run_rsim(64, 4096, lookahead=False, device="cpu")
    ref_on, ref_allocs_on, ref_stats, _ = EX_RSIM.run(lookahead=True)
    _, ref_allocs_off, _, _ = EX_RSIM.run(lookahead=False)
    assert (allocs_on, allocs_off) == (ref_allocs_on, ref_allocs_off)
    assert allocs_on < allocs_off
    assert (stats.flushes, stats.commands_queued_peak) == \
        (ref_stats.flushes, ref_stats.commands_queued_peak)
    np.testing.assert_array_equal(on, off)
    # the row sums run in torch's order, not numpy's: up to an ulp apart
    np.testing.assert_allclose(on, ref_on, rtol=1e-14, atol=0)
