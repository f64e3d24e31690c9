"""The torch port's runtime slice held against ``repro.core.Runtime``.

The same programs (the Listing-1 N-body of ``examples/quickstart.py`` and the
WaveSim loop of ``examples/wavesim.py``) run on both runtimes on the CPU
(``device="cpu"``) on 1x1, 2x2 and 3x1 grids: the lowering is a copy, so the
instruction and message counts must be equal, and the values agree with the
JAX oracles of ``repro.kernels.ref`` within the stated tolerances.
"""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Runtime as RefRuntime
from repro.core import all_range, neighborhood, one_to_one, read, read_write
from repro.core import write
from repro.core.communicator import Payload as RefPayload
from repro.core.region import Box
from repro.kernels import ref
from repro_torch.apps import NBody, WaveSim, run_nbody, run_wave
from repro_torch.core import Runtime
from repro_torch.core.allocation import USER_HOST, Allocation
from repro_torch.core.communicator import Payload
from repro_torch.core.executor import BufferView
from torch_parity import keep_reference_ids  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GRIDS = [(1, 1), (2, 2), (3, 1)]
# no retransmit can fire in a fault-free run, so transport counters are
# comparable between the two runtimes however loaded the host is
QUIET = dict(retransmit_timeout=60.0)
DT, MASS = 0.01, 1.0


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_nbody(q, P0, V0, steps, forces):
    """The quickstart program on the reference runtime, with ``forces``."""
    N = P0.shape[0]
    P = q.buffer((N, 3), init=P0, name="P")
    V = q.buffer((N, 3), init=V0, name="V")

    def timestep(chunk, p, v):
        Pa = p.get(Box((0, 0), (N, 3)))
        F = forces(Pa, chunk.min[0], chunk.max[0])
        v.set(chunk, v.get(chunk) + MASS * F * DT)

    def update(chunk, v, p):
        p.set(chunk, p.get(chunk) + v.get(chunk) * DT)

    for _ in range(steps):
        q.submit("timestep", (N, 3),
                 [read(P, all_range()), read_write(V, one_to_one())], timestep)
        q.submit("update", (N, 3),
                 [read(V, one_to_one()), read_write(P, one_to_one())], update)
    return q.gather(P)


def _ref_wave(q, u0, u1, steps):
    """The wavesim loop on the reference runtime, with its numpy kernel."""
    H, W = u1.shape
    step_kernel = _example("wavesim")._make_step_kernel(H, W)
    B = [q.buffer((H, W), init=u0, name="um"),
         q.buffer((H, W), init=u1, name="u"),
         q.buffer((H, W), init=np.zeros((H, W)), name="un")]
    for s in range(steps):
        um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
        q.submit(f"wave{s}", (H, W),
                 [read(um, one_to_one()), read(u, neighborhood((1, 0))),
                  write(un, one_to_one())], step_kernel)
    return q.gather(B[(steps + 1) % 3])


def _bodies(N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, 3)), rng.normal(size=(N, 3)) * 0.1


def _splash(H, W):
    u1 = np.zeros((H, W))
    u1[H // 2 - 4:H // 2 + 4, W // 2 - 4:W // 2 + 4] = 1.0
    return u1.copy(), u1


def _structure(rt):
    return dict(instructions=rt.total_instructions(),
                bytes=rt.comm.bytes_sent, messages=rt.comm.num_messages,
                comm=rt.comm_stats(),
                live=[r["real_used"] for r in rt.memory_report()])


# -- structure -----------------------------------------------------------------
@pytest.mark.parametrize("nodes,devices", GRIDS)
def test_nbody_structure_equals_reference(nodes, devices):
    P0, V0 = _bodies(96)
    gravity = _example("quickstart").gravity_forces
    with RefRuntime(nodes, devices, **QUIET) as q:
        exp = _ref_nbody(q, P0, V0, 3, gravity)
        ref_s = _structure(q)
    with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
        got = run_nbody(rt, P0, V0, 3, DT, MASS)
        port_s = _structure(rt)
    assert port_s == ref_s
    assert ref_s["messages"] > 0 or nodes == 1
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nodes,devices", GRIDS)
def test_wave_structure_equals_reference(nodes, devices):
    u0, u1 = _splash(48, 40)
    with RefRuntime(nodes, devices, **QUIET) as q:
        _ref_wave(q, u0, u1, 6)
        ref_s = _structure(q)
    with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
        run_wave(rt, u0, u1, 6)
        port_s = _structure(rt)
    assert port_s == ref_s


# -- values ----------------------------------------------------------------------
@pytest.mark.parametrize("nodes,devices", GRIDS)
def test_nbody_positions_match_reference(nodes, devices):
    """N = 256, 5 float64 steps; both compute forces in f32 (the port's
    kernel does so by design, the JAX oracle under JAX's default f32), so
    they agree to f32 rounding and not bit for bit."""
    P0, V0 = _bodies(256, seed=3)

    def forces(Pa, lo, hi):
        return np.asarray(ref.nbody_forces_ref(Pa, Pa[lo:hi]))

    with RefRuntime(nodes, devices, **QUIET) as q:
        exp = _ref_nbody(q, P0, V0, 5, forces)
    with Runtime(nodes, devices, device="cpu", **QUIET) as rt:
        got = run_nbody(rt, P0, V0, 5, DT, MASS)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)


def test_nbody_positions_independent_of_grid():
    P0, V0 = _bodies(100, seed=4)
    results = []
    for nodes, devices in GRIDS:
        with Runtime(nodes, devices, device="cpu") as rt:
            results.append(run_nbody(rt, P0, V0, 3, DT, MASS))
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])


def test_apps_advance_in_pieces_as_in_one_go():
    P0, V0 = _bodies(64, seed=6)
    u0, u1 = _splash(24, 16)
    with Runtime(2, 2, device="cpu") as rt:
        whole = run_nbody(rt, P0, V0, 5, DT, MASS), run_wave(rt, u0, u1, 5)
        nbody, wave = NBody(rt, P0, V0, DT, MASS), WaveSim(rt, u0, u1)
        for steps in (1, 0, 4):
            nbody.advance(steps)
            wave.advance(steps)
            rt.sync()
        pieces = nbody.gather(), wave.gather()
    for a, b in zip(whole, pieces):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nodes,devices", GRIDS)
def test_wave_field_matches_oracle(nodes, devices):
    """The field is within 1e-4 of iterated ``ref.wave_step_ref``, as at
    ``examples/wavesim.py``."""
    H, W, steps = 64, 48, 20
    u0, u1 = _splash(H, W)
    with Runtime(nodes, devices, device="cpu") as rt:
        got = run_wave(rt, u0, u1, steps)
    um, u = u0, u1
    for _ in range(steps):
        um, u = u, ref.wave_step_ref(um, u, 0.25)
    assert float(np.abs(got - np.asarray(u)).max()) < 1e-4


# -- sanitizer, device rule -----------------------------------------------
def test_sanitizer_stays_clean_on_2x2():
    P0, V0 = _bodies(64, seed=5)
    u0, u1 = _splash(32, 16)
    with Runtime(2, 2, device="cpu", verify="final") as rt:
        run_nbody(rt, P0, V0, 3, DT, MASS)
        run_wave(rt, u0, u1, 4)
        rt.verifier.check()
        assert rt.warnings == [] and rt.verifier.issues == []
        assert sum(len(s) for s in rt.verifier.streams) > 0


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runtime()
    with pytest.raises(ValueError):
        Runtime(device="cuda:1")


# -- executor pieces -------------------------------------------------------------------
def test_m0_seeding_copies_the_user_init():
    init = np.arange(12.0).reshape(4, 3)
    with Runtime(device="cpu") as rt:
        alloc = Allocation(mid=USER_HOST, bid=None, box=Box((0, 0), (4, 3)),
                           initial_data=init)
        t = rt.executors[0]._arr(alloc)
        assert rt.executors[0]._arr(alloc) is t
    assert t.dtype == torch.float64 and torch.equal(t, torch.from_numpy(init))
    init[0, 0] = 99.0
    assert t[0, 0] == 0.0


def test_payload_bytes_equal_reference():
    data = np.arange(24, dtype=np.float32).reshape(4, 6)
    frags = [((0, 1), data[1]), (Box((0, 0), (2, 6)), data[:2])]
    ref_p = [RefPayload(0, 1, (1, 2), data=data[1:3].copy()),
             RefPayload(0, 1, (1, 2, 2, 0), fragments=frags)]
    port_p = [Payload(0, 1, (1, 2), data=torch.from_numpy(data[1:3].copy())),
              Payload(0, 1, (1, 2, 2, 0),
                      fragments=[(k, torch.from_numpy(v)) for k, v in frags])]
    assert [p.nbytes() for p in port_p] == [p.nbytes() for p in ref_p]


def test_buffer_view_assigns_numpy_on_the_view_device():
    class _Binding:
        region = None

        class accessor:
            class mode:
                is_producer = True

    t = torch.zeros(4, 3, dtype=torch.float32)
    alloc = Allocation(mid=2, bid=None, box=Box((2, 0), (6, 3)))
    v = BufferView(t, alloc, _Binding, check_bounds=False)
    v[3:5, :] = np.ones((2, 3))
    assert t.dtype == torch.float32 and t[1:3].eq(1).all() and t.sum() == 6
    assert isinstance(v.get(Box((2, 0), (3, 3))), torch.Tensor)


# -- hygiene and the chip smoke script ----------------------------------------------------
def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 20 and not bad


def test_port_run_loads_no_jax_or_repro():
    code = ("import sys, numpy as np\n"
            "from repro_torch.core import Runtime\n"
            "from repro_torch.apps import run_nbody, run_wave\n"
            "with Runtime(2, 1, device='cpu') as rt:\n"
            "    run_nbody(rt, np.ones((8, 3)), np.zeros((8, 3)), 1, 0.1, 1.0)\n"
            "    run_wave(rt, np.zeros((8, 4)), np.ones((8, 4)), 2)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
