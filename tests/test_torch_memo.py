"""The torch port's serving runtime (``core/memo.py``) held against
``repro.core``.

The cases of ``tests/test_memo.py`` run on both packages' ``ServingRuntime``
on the CPU (the port with ``device="cpu"``).  The lowering and the memo
cache are copies, so for each case the instruction counts and
``memo_stats()`` (hits, misses, unreplayable windows, evictions, and per
tenant the lowered and replayed windows, tasks, instructions and
completions) must be equal.  The port's bytes must equal those of the same
program on its own ``Runtime``, and the reference's those of its own; where a
numpy oracle exists the port's float64 values are held to it within
``RTOL`` = 1e-12 (the kernels are the same elementwise float64 operations,
so equality is expected; the tolerance only allows for another summation
order in a reduction).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.memo import _Call as RefCall
from repro_torch.core.memo import _Call as PortCall
from torch_parity import keep_reference_ids  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GRIDS = [(1, 1), (2, 2), (3, 1)]
N = 12
RTOL = 1e-12
APIS = [ref_core, port_core]


def _device(api):
    return {"device": "cpu"} if api is port_core else {}


def _serving(api, *args, **kw):
    return api.ServingRuntime(*args, **kw, **_device(api))


def _runtime(api, *args, **kw):
    return api.Runtime(*args, **kw, **_device(api))


def _memo_structure(srv):
    """The parts of ``memo_stats()`` that do not depend on timing.  The
    port lowers again, without executing them, windows replayed before a
    cold lowering whose scheduler state the reference never caught up
    (``Tenant._catch_up``); that lowering's tasks and instructions are taken
    out, and the number of such windows is returned beside."""
    s = srv.memo_stats()
    caught_up = {}
    tenants = {}
    for name, t in s["tenants"].items():
        t = {k: v for k, v in t.items() if k != "window_peak"}
        c = t.pop("caught_up", None)
        if c is not None:
            t["tasks"] -= c["tasks"]
            t["instructions"] -= c["instructions"]
            caught_up[name] = c["windows"]
        tenants[name] = t
    return dict(hits=s["hits"], misses=s["misses"],
                unreplayable=s["unreplayable"], evictions=s["evictions"],
                tenants=tenants), caught_up


def step_kernel(chunk, v):
    v.set(chunk, v.get(chunk) * 1.0001 + 1.0)


def step_oracle(a):
    return a * 1.0001 + 1.0


def red_kernel(chunk, v, acc):
    x = v.get(chunk)
    s = float(x.sum())
    v.set(chunk, x + 0.5)
    acc.contribute(s)


def _oracle(a, k):
    for _ in range(k):
        a = step_oracle(a)
    return a


def _serve(api, nodes, devs, program, **kw):
    """``program(api, q, end)`` on one tenant of ``api``'s serving runtime
    (``end()`` closes a window); its gathered arrays and the memo
    structure."""
    with _serving(api, nodes, devs, **kw) as srv:
        t = srv.tenant("t0")
        out = program(api, t, t.run)
        t.drain()
        structure, caught_up = _memo_structure(srv)
    return out, structure, caught_up.get("t0", 0)


def _plain(api, nodes, devs, program):
    """The same program on ``api``'s plain ``Runtime``: no windows."""
    with _runtime(api, nodes, devs) as rt:
        return program(api, rt, lambda: None)


def _check(nodes, devs, program, caught_up=0, **kw):
    """Both packages: equal memo structure, with ``caught_up`` windows
    lowered again by the port; each package's serving bytes equal to its
    own plain runtime's.  Returns the port's arrays, the reference's and the
    structure."""
    got, port_s, port_c = _serve(port_core, nodes, devs, program, **kw)
    exp, ref_s, _ = _serve(ref_core, nodes, devs, program, **kw)
    assert port_s == ref_s
    assert port_c == caught_up
    for api, vals in ((port_core, got), (ref_core, exp)):
        for a, b in zip(vals, _plain(api, nodes, devs, program)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    return got, exp, port_s


# -- bit-identical replay vs cold lowering ------------------------------------
def _windows_program(api, q, end):
    a0 = np.arange(N * N, dtype=np.float64).reshape(N, N)
    buf = q.buffer((N, N), init=a0, name="A")
    out = []
    for _ in range(8):
        q.submit("step", (N, N), [api.read_write(buf, api.one_to_one())],
                 step_kernel)
        end()
        out.append(q.gather(buf))
    return out


@pytest.mark.parametrize("nodes,devs", GRIDS)
def test_replay_bit_identical(nodes, devs):
    got, _, s = _check(nodes, devs, _windows_program)
    want = np.arange(N * N, dtype=np.float64).reshape(N, N)
    for w, g in enumerate(got):
        want = step_oracle(want)
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=0,
                                   err_msg=f"window {w}")
    assert s["tenants"]["t0"]["replayed"] > 0 and s["hits"] > 0


def _reduction_program(api, q, end):
    a0 = np.arange(N, dtype=np.float64)
    buf = q.buffer((N,), init=a0, name="A")
    s = q.buffer((1,), init=np.zeros(1), name="S")
    out = []
    for _ in range(8):
        q.submit("step", (N,), [api.read_write(buf, api.one_to_one()),
                                api.reduction(s, "sum")], red_kernel)
        end()
        out.append(q.gather(s))
    out.append(q.gather(buf))
    return out


@pytest.mark.parametrize("nodes,devs", GRIDS)
def test_replay_bit_identical_reduction(nodes, devs):
    # step and gather windows alternate; the last one, a replayed gather of
    # S, is lowered again before the gather of A lowers cold
    got, exp, s = _check(nodes, devs, _reduction_program, caught_up=1)
    a = np.arange(N, dtype=np.float64)
    for w in range(8):
        assert got[w][0] == exp[w][0] == a.sum(), f"window {w}"
        a = a + 0.5
    np.testing.assert_array_equal(got[-1], a)
    assert s["tenants"]["t0"]["replayed"] > 0 and s["unreplayable"] == 0


def test_replay_matches_plain_runtime():
    a0 = np.linspace(-3, 3, N * N).reshape(N, N)

    def program(api, q, end):
        pb = q.buffer((N, N), init=a0, name="P")
        for _ in range(6):
            q.submit("step", (N, N), [api.read_write(pb, api.one_to_one())],
                     step_kernel)
            end()
        return [q.gather(pb)]

    got, exp, _ = _check(2, 2, program)
    np.testing.assert_allclose(got[0], _oracle(a0, 6), rtol=RTOL, atol=0)


# -- zero lowering on cache hits ----------------------------------------------
@pytest.mark.parametrize("api", APIS, ids=["reference", "port"])
def test_cache_hit_performs_zero_lowering(api):
    a0 = np.ones((N, N))
    with _serving(api, 2, 1) as srv:
        t = srv.tenant("t0")
        buf = t.buffer((N, N), init=a0, name="A")

        def window():
            t.submit("step", (N, N), [api.read_write(buf, api.one_to_one())],
                     step_kernel)
            t.run().wait()

        for _ in range(4):
            window()
        t.drain()
        assert t.replayed_windows > 0, "template was never captured"
        tasks0 = t.tdag.task_count
        instrs0 = sum(g.emitted_count for g in t.idags)
        hits0 = srv.memo_stats()["hits"]
        for _ in range(5):
            window()
        t.drain()
        assert t.tdag.task_count == tasks0
        assert sum(g.emitted_count for g in t.idags) == instrs0
        assert srv.memo_stats()["hits"] == hits0 + 5
        assert t.gather(buf)[0, 0] == _oracle(1.0, 9)


def test_memo_off_never_replays():
    def program(api, q, end):
        buf = q.buffer((N,), init=np.ones(N))
        for _ in range(5):
            q.submit("step", (N,), [api.read_write(buf, api.one_to_one())],
                     step_kernel)
            end()
        return [q.gather(buf)]

    got, _, s = _check(1, 1, program, memo=False)
    assert s["tenants"]["t0"]["replayed"] == 0
    assert s["tenants"]["t0"]["lowered"] == 6          # five and the gather
    np.testing.assert_allclose(got[0], _oracle(np.ones(N), 5), rtol=RTOL)


# -- invalidation: near-identical windows that MUST miss ----------------------
def _warm(api, q, end, buf, k=4):
    for _ in range(k):
        q.submit("step", (N,), [api.read_write(buf, api.one_to_one())],
                 step_kernel)
        end()


def test_miss_on_changed_range_mapper():
    a0 = np.arange(N, dtype=np.float64)

    def narrow(chunk, s, d):
        d.set(chunk, s.get(chunk) * 2.0)

    def widened(chunk, s, d):
        total = float(s.get(port_core.Box((0,), (N,))).sum())
        d.set(chunk, torch.full(chunk.shape, total, dtype=torch.float64)
              if isinstance(d.array, torch.Tensor)
              else np.full(chunk.shape, total))

    def program(api, q, end):
        buf = q.buffer((N,), init=a0, name="A")
        out = q.buffer((N,), init=np.zeros(N), name="O")
        _warm(api, q, end, buf)
        q.submit("proj", (N,), [api.read(buf, api.one_to_one()),
                                api.read_write(out, api.one_to_one())], narrow)
        end()
        q.submit("proj", (N,), [api.read(buf, api.all_range()),
                                api.read_write(out, api.one_to_one())],
                 widened)
        end()
        return [q.gather(out)]

    got, _, s = _check(2, 1, program)
    # four warm-up windows (two cold, capture, replay), two misses, gather
    assert s["misses"] == 6 and s["hits"] == 1
    np.testing.assert_allclose(got[0], np.full(N, _oracle(a0, 4).sum()),
                               rtol=RTOL)


def test_miss_on_changed_granularity():
    a0 = np.arange(N, dtype=np.float64)

    def program(api, q, end):
        buf = q.buffer((N,), init=a0, name="A")
        _warm(api, q, end, buf)
        q.submit("step", (N,), [api.read_write(buf, api.one_to_one())],
                 step_kernel, granularity=(3,))
        end()
        return [q.gather(buf)]

    got, _, s = _check(2, 1, program)
    assert s["misses"] == 5 and s["hits"] == 1
    np.testing.assert_allclose(got[0], _oracle(a0, 5), rtol=RTOL)


def test_miss_on_changed_reduction():
    a0 = np.arange(N, dtype=np.float64)

    def ksum(chunk, v, acc):
        acc.contribute(float(v.get(chunk).sum()))

    def kmax(chunk, v, acc):
        acc.contribute(float(v.get(chunk).max()))

    def program(api, q, end):
        buf = q.buffer((N,), init=a0, name="A")
        s = q.buffer((1,), init=np.zeros(1), name="S")
        for _ in range(4):
            q.submit("r", (N,), [api.read(buf, api.one_to_one()),
                                 api.reduction(s, "sum")], ksum)
            end()
        q.submit("r", (N,), [api.read(buf, api.one_to_one()),
                             api.reduction(s, "max")], kmax)
        end()
        mx = q.gather(s)
        q.submit("r", (N,), [api.read(buf, api.one_to_one()),
                             api.reduction(s, "sum",
                                           include_current_value=True)], ksum)
        end()
        return [mx, q.gather(s)]

    got, exp, s = _check(2, 1, program)
    assert got[0][0] == exp[0][0] == a0.max()
    assert got[1][0] == exp[1][0] == a0.max() + a0.sum()
    assert s["misses"] >= 2


def _mk_call(call_cls, api, granularity=(1,)):
    return call_cls("k", api.Box((0,), (N,)), (), None, api.TaskType.KERNEL,
                    (0,), granularity)


def test_signature_covers_grid_budgets_namespace():
    """Equal signatures in both packages, and each changes with the grid,
    the budgets, the namespace, the config, the chunking and the calls."""
    base = dict(num_nodes=2, devices_per_node=2,
                config=(True, True, True, True, 4, True),
                budgets={3: 1 << 20}, namespace="a")

    def sigs(calls, **kw):
        return [api.window_signature([_mk_call(c, api, **g) for g in calls],
                                     **{**base, **kw})
                for c, api in ((RefCall, ref_core), (PortCall, port_core))]

    ref_sig, port_sig = sigs([{}])
    assert port_sig == ref_sig == sigs([{}])[1]
    for change in (dict(num_nodes=3), dict(devices_per_node=1),
                   dict(budgets={3: 1 << 21}), dict(budgets=None),
                   dict(namespace="b"),
                   dict(config=(True, True, True, True, 8, True))):
        r, p = sigs([{}], **change)
        assert p == r and p != port_sig, change
    for calls in ([{"granularity": (2,)}], [{}, {}]):
        r, p = sigs(calls)
        assert p == r and p != port_sig, calls


# -- multi-tenancy ------------------------------------------------------------
@pytest.mark.parametrize("api", APIS, ids=["reference", "port"])
def test_cross_tenant_buffer_rejected(api):
    with _serving(api, 1, 1) as srv:
        ta = srv.tenant("a")
        tb = srv.tenant("b")
        stolen = ta.buffer((N,), init=np.zeros(N), name="secret")
        tb.submit("smuggle", (N,), [api.read_write(stolen, api.one_to_one())],
                  step_kernel)
        with pytest.raises(PermissionError):
            tb.run()


@pytest.mark.parametrize("api", APIS, ids=["reference", "port"])
def test_duplicate_tenant_name_rejected(api):
    with _serving(api, 1, 1) as srv:
        srv.tenant("a")
        with pytest.raises(ValueError):
            srv.tenant("a")


def _tenant_steps(api, q, end, scale, windows):
    buf = q.buffer((N,), init=np.full(N, scale), name="A")
    _warm(api, q, end, buf, windows)
    return [q.gather(buf)]


def _concurrent(api):
    wins = 10
    results, structure = {}, None
    with _serving(api, 2, 1, max_inflight_per_tenant=8) as srv:
        def client(name, scale):
            t = srv.tenant(name)
            results[name] = _tenant_steps(api, t, t.run, scale, wins)[0]

        threads = [threading.Thread(target=client, args=(f"t{i}", 1.0 + i))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for ex in srv.executors:
            assert set(ex.tenant_done) == {"t0", "t1"}
            assert all(cnt > 0 for cnt in ex.tenant_done.values())
            assert ex._deferred_count == 0
            assert all(v == 0 for v in ex._tenant_inflight.values())
        structure, caught_up = _memo_structure(srv)
    assert caught_up == {"t0": 0, "t1": 0} or api is ref_core
    return results, structure


def test_concurrent_tenants_isolated_and_fair():
    got, port_s = _concurrent(port_core)
    exp, ref_s = _concurrent(ref_core)
    assert port_s == ref_s
    for i in range(2):
        plain = _plain(port_core, 2, 1, lambda api, q, end: _tenant_steps(
            api, q, end, 1.0 + i, 10))[0]
        np.testing.assert_array_equal(got[f"t{i}"], plain)
        np.testing.assert_allclose(got[f"t{i}"], _oracle(np.full(N, 1.0 + i),
                                                         10), rtol=RTOL)


def _soak(api):
    wins = 25
    with _serving(api, 2, 1) as srv:
        tenants = []
        for i in range(2):
            t = srv.tenant(f"t{i}")
            buf = t.buffer((N,), init=np.full(N, float(i + 1)), name="A")
            tenants.append((t, buf))
        for _ in range(wins):
            for t, buf in tenants:
                t.submit("step", (N,), [api.read_write(buf, api.one_to_one())],
                         step_kernel)
                t.run()
        out = []
        for t, buf in tenants:
            t.drain()
            out.append(t.gather(buf))
        for ex in srv.executors:
            assert len(ex.arbiter.received) == 0
            assert len(ex._completed_epochs) <= 2 * 8 + 2
            assert not ex._blocked
        for t, _ in tenants:
            assert t.replayed_windows >= wins - 4
            assert t.lowered_windows <= 8
        structure, caught_up = _memo_structure(srv)
        assert caught_up == {"t0": 0, "t1": 0} or api is ref_core
        return out, structure


def test_soak_bounded_state():
    got, port_s = _soak(port_core)
    _, ref_s = _soak(ref_core)
    assert port_s == ref_s
    for i, g in enumerate(got):
        plain = _plain(port_core, 2, 1, lambda api, q, end: _tenant_steps(
            api, q, end, float(i + 1), 25))[0]
        np.testing.assert_array_equal(g, plain)


# -- the launcher's scheduler engine ------------------------------------------
def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "scheduler", "--tenants", "2", "--windows", "12", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_launcher_scheduler_engine_verifies_on_cpu():
    r = _launch("--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "results verified: every element == 12.0" in r.stdout
    assert "(cpu)" in r.stdout and "hits=" in r.stdout


def test_launcher_scheduler_engine_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _launch()
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "results verified" not in r.stdout


# -- two simulations as tenants (chip_smoke.py's serving-runtime phase) -------
# memo_stats() of the phase's window sequence: 40 WaveSim windows and 10
# N-body windows on 2 x 2, then a gather each.  The counts depend on the
# window sequence and the grid, not on the sizes: the card's run must match.
SERVING_COUNTS = {
    "memo": ((36, 16, 0), {"wave": (11, 30), "nbody": (5, 6)}),
    "memo_off": ((0, 0, 0), {"wave": (41, 0), "nbody": (11, 0)}),
    # under renaming a buffer's physical alternates between windows, so the
    # WaveSim shapes never reach the capture fixpoint (memo.py's digest)
    "memo_renaming": ((6, 46, 0), {"wave": (41, 0), "nbody": (5, 6)}),
}
SERVING_RUNS = {"memo": dict(memo=True), "memo_off": dict(memo=False),
                "memo_renaming": dict(memo=True, renaming=True,
                                      max_inflight_windows=2,
                                      verify="window")}


def _runtime_free(u0, u1, P0, V0, wave_steps, nbody_steps, dt, mass):
    """The same steps without the runtime: B2 and B1 on the whole arrays
    (their plain versions on CPU tensors)."""
    from repro_torch.kernels.nbody import nbody_forces_rows
    from repro_torch.kernels.stencil5 import wave_step_rows
    um, u = torch.from_numpy(u0), torch.from_numpy(u1)
    for _ in range(wave_steps):
        um, u = u, wave_step_rows(um, u, 0, u.shape[0], 0.25)
    P, V = torch.from_numpy(P0), torch.from_numpy(V0)
    for _ in range(nbody_steps):
        F = nbody_forces_rows(P, 0, P.shape[0])
        V = V + mass * F * dt
        P = P + V * dt
    return u.numpy(), P.numpy()


@pytest.mark.parametrize("run", sorted(SERVING_RUNS))
@pytest.mark.parametrize("H,W,bodies", [(64, 32, 64), (96, 40, 200)])
def test_served_simulations_counts_and_bits(run, H, W, bodies):
    from repro_torch.apps import serve_simulations
    rng = np.random.default_rng(H)
    u0 = rng.standard_normal((H, W), dtype=np.float32)
    u1 = rng.standard_normal((H, W), dtype=np.float32)
    P0 = rng.standard_normal((bodies, 3), dtype=np.float32)
    V0 = rng.standard_normal((bodies, 3), dtype=np.float32) * 0.1
    dt, mass = 1e-3, 1.0 / bodies
    with port_core.ServingRuntime(2, 2, device="cpu",
                                  **SERVING_RUNS[run]) as srv:
        out = serve_simulations(srv, u0, u1, P0, V0, wave_windows=40,
                                nbody_windows=10, dt=dt, mass=mass)
        s = srv.memo_stats()
        if srv.verifier is not None:
            assert srv.verify_now().ok
    totals, tenants = SERVING_COUNTS[run]
    assert (s["hits"], s["misses"], s["unreplayable"]) == totals
    assert {n: (t["lowered"], t["replayed"])
            for n, t in s["tenants"].items()} == tenants
    field, P = _runtime_free(u0, u1, P0, V0, 40, 10, dt, mass)
    np.testing.assert_array_equal(out["wave"]["field"], field)
    np.testing.assert_array_equal(out["nbody"]["P"], P)
    assert len(out["wave"]["latency_s"]) == 40
    assert len(out["nbody"]["latency_s"]) == 10


# -- windows of several shapes in turn (fault C3) -----------------------------
# WaveSim's buffers rotate, so its windows take three shapes in turn.  The
# reference replays a template after any window and leaves the scheduler
# state at the last cold lowering, so the cold windows after replays (here
# the gathers) and replays after another predecessor read stale halo copies
# (rows 16, 31, 32 and 48 of these 64-row fields).  Every order must give
# the bytes of memo off.
ROTATIONS = {"cycle_11": [i % 3 for i in range(11)],
             "cycle_12": [i % 3 for i in range(12)],
             "cycle_40": [i % 3 for i in range(40)],
             "cycle_then_reversed": [i % 3 for i in range(12)] + [0, 2, 1] * 2,
             "cycle_then_pairs": [i % 3 for i in range(12)]
             + [0, 0, 1, 1, 2, 2, 0],
             # the windows after the first four grow the halo allocations
             # that the template of shape 0 was captured without
             "repeat_then_cycle": [0, 0, 0, 0, 2, 0, 1, 2, 0, 0],
             # the template of shape 0, captured after shape 0 (no halo to
             # copy), must not replay after shape 2, which rewrote the halo
             "cycle_repeat_cycle": [0, 1, 2] * 2 + [0] * 4 + [2, 0, 0]}


def _rotating(order, memo):
    from repro_torch.apps.wavesim import make_step_kernel
    H, W = 64, 32
    rng = np.random.default_rng(38)
    u0 = rng.standard_normal((H, W), dtype=np.float32)
    u1 = rng.standard_normal((H, W), dtype=np.float32)
    with port_core.ServingRuntime(2, 2, device="cpu", memo=memo) as srv:
        t = srv.tenant("w")
        kernel = make_step_kernel(H, W, 0.25)
        B = [t.buffer((H, W), dtype=np.float32, init=u, name=n)
             for n, u in (("um", u0), ("u", u1), ("un", np.zeros_like(u1)))]
        for s in order:
            um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
            t.submit("wave", (H, W), [port_core.read(um, port_core.one_to_one()),
                                      port_core.read(u, port_core.neighborhood(
                                          (1, 0))),
                                      port_core.write(un, port_core.one_to_one())],
                     kernel)
            t.run()
        return [t.gather(b) for b in B], srv.memo_stats()["tenants"]["w"]


@pytest.mark.parametrize("order", sorted(ROTATIONS))
def test_rotating_windows_replay_as_cold(order):
    got, stats = _rotating(ROTATIONS[order], memo=True)
    want, _ = _rotating(ROTATIONS[order], memo=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert stats["replayed"] > 0


# -- fault C5: an admission cap of 1 on windows that exchange between nodes ---
EXCHANGE_N = 64
EXCHANGE_DEADLINE_S = 30.0


def _add_one(chunk, src, dst):
    dst.set(chunk, src.get(chunk) + 1.0)


def _exchange(read_mapper, cap):
    """One tenant on the port's ``ServingRuntime(2, 1)`` with
    ``max_inflight_per_tenant=cap``: window 1 computes ``B <- A + 1``,
    window 2 ``A <- B + 1``, each reading its source through
    ``read_mapper`` (so each node receives the other's half), then A is
    gathered.  Returns A and each executor's in-flight counts after the
    drain."""
    with _serving(port_core, 2, 1, max_inflight_per_tenant=cap) as srv:
        t = srv.tenant("t0")
        a = t.buffer((EXCHANGE_N,), name="A",
                     init=np.arange(EXCHANGE_N, dtype=np.float64))
        b = t.buffer((EXCHANGE_N,), init=np.zeros(EXCHANGE_N), name="B")
        for src, dst in ((a, b), (b, a)):
            t.submit(f"{dst.name} <- {src.name} + 1", (EXCHANGE_N,),
                     [port_core.read(src, read_mapper),
                      port_core.write(dst, port_core.one_to_one())], _add_one)
            t.run()
        out = t.gather(a)
        t.drain()
        inflight = [dict(ex._tenant_inflight) for ex in srv.executors]
    return out, inflight


@pytest.mark.parametrize("reads", ["neighborhood", "all_range"])
def test_admission_cap_of_one_on_exchanging_windows(reads):
    """Fault C5: with a cap of 1, each node's receive used to hold the
    tenant's one slot while the peer's send waited behind the peer's own
    receive, and the gather never returned.  Under a deadline (a daemon
    thread, so a regression fails instead of hanging the suite) the capped
    run must give the bytes of the uncapped one and drain its counts."""
    mapper = (port_core.neighborhood((1,)) if reads == "neighborhood"
              else port_core.all_range())
    result = {}

    def capped():
        try:
            result["out"] = _exchange(mapper, 1)
        except BaseException as e:      # reported by the test thread
            result["error"] = e

    th = threading.Thread(target=capped, daemon=True)
    th.start()
    th.join(EXCHANGE_DEADLINE_S)
    assert not th.is_alive(), (
        f"cap 1 did not finish within {EXCHANGE_DEADLINE_S} s (fault C5)")
    if "error" in result:
        raise result["error"]
    got, inflight = result["out"]
    want, _ = _exchange(mapper, None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.arange(EXCHANGE_N) + 2.0)
    assert all(v == 0 for counts in inflight for v in counts.values())


# -- fault C6: pipelined replay (max_inflight_windows >= 2) -------------------
# Window m of a tenant waits only for window m - depth; the hazard edges of
# ``Tenant._replay`` must order every conflicting pair of accesses between
# the windows in flight.  ``verify="final"`` checks races across windows
# (window mode checks each window alone), and clients that submit every
# window before they drain let the windows overlap for real.
def _sim_inputs(H, W, bodies, seed):
    rng = np.random.default_rng(seed)
    P0 = rng.standard_normal((bodies, 3), dtype=np.float32)
    V0 = rng.standard_normal((bodies, 3), dtype=np.float32) * 0.1
    u0 = rng.standard_normal((H, W), dtype=np.float32)
    u1 = rng.standard_normal((H, W), dtype=np.float32)
    return u0, u1, P0, V0, 1e-3, 1.0 / bodies


PIPELINED_FINAL = [  # (nodes, devs, depth, renaming)
    (2, 2, 2, False), (2, 2, 2, True), (2, 2, 3, False), (2, 2, 3, True),
    (3, 1, 2, True)]


@pytest.mark.parametrize("H,W,bodies", [(64, 32, 64), (96, 40, 200)])
@pytest.mark.parametrize("nodes,devs,depth,renaming", PIPELINED_FINAL)
def test_pipelined_replay_verifies_final(nodes, devs, depth, renaming, H, W,
                                         bodies):
    """Fault C6: the schedule of pipelined replays has a happens-before
    edge between every pair of conflicting accesses, across windows too.
    On 2 x 2 the memo counts are those of depth 1."""
    from repro_torch.apps import serve_simulations
    u0, u1, P0, V0, dt, mass = _sim_inputs(H, W, bodies, H)
    with port_core.ServingRuntime(nodes, devs, device="cpu", memo=True,
                                  renaming=renaming, verify="final",
                                  max_inflight_windows=depth) as srv:
        out = serve_simulations(srv, u0, u1, P0, V0, wave_windows=40,
                                nbody_windows=10, dt=dt, mass=mass)
        s = srv.memo_stats()
        report = srv.verify_now()
    assert report.ok and not report.issues
    if (nodes, devs) == (2, 2):
        totals, tenants = SERVING_COUNTS[
            "memo_renaming" if renaming else "memo"]
        assert (s["hits"], s["misses"], s["unreplayable"]) == totals
        assert {n: (t["lowered"], t["replayed"])
                for n, t in s["tenants"].items()} == tenants
    field, P = _runtime_free(u0, u1, P0, V0, 40, 10, dt, mass)
    np.testing.assert_array_equal(out["wave"]["field"], field)
    np.testing.assert_array_equal(out["nbody"]["P"], P)


NO_WAIT_REPEATS = 5
NO_WAIT_WINDOWS = {"wave": 40, "nbody": 10}


@pytest.mark.parametrize("renaming", [False, True], ids=["plain", "renaming"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("tenant", sorted(NO_WAIT_WINDOWS))
def test_no_wait_tenant_bitwise(tenant, depth, renaming):
    """Fault C6: a WaveSim (64 x 32, 40 windows) or N-body (200 bodies, 10
    windows) client that submits every window and drains once.  Each of
    ``NO_WAIT_REPEATS`` runs (a missing edge shows only when the threads
    interleave badly) gives the bytes of memo off and of the runtime-free
    steps."""
    from repro_torch.apps import serve_simulations
    u0, u1, P0, V0, dt, mass = _sim_inputs(64, 32, 200, 0)
    windows = {k: (v if k == tenant else 0)
               for k, v in NO_WAIT_WINDOWS.items()}
    field, P = _runtime_free(u0, u1, P0, V0, windows["wave"],
                             windows["nbody"], dt, mass)
    want = {"wave": ("field", field), "nbody": ("P", P)}[tenant]

    def run(memo):
        with port_core.ServingRuntime(2, 2, device="cpu", memo=memo,
                                      renaming=renaming,
                                      max_inflight_windows=depth) as srv:
            out = serve_simulations(srv, u0, u1, P0, V0,
                                    wave_windows=windows["wave"],
                                    nbody_windows=windows["nbody"], dt=dt,
                                    mass=mass, wait=False)
            replayed = srv.tenants[tenant].replayed_windows
        return out[tenant][want[0]], replayed

    off, _ = run(False)
    np.testing.assert_array_equal(off, want[1])
    for rep in range(NO_WAIT_REPEATS):
        got, replayed = run(True)
        # under renaming WaveSim's windows never reach the capture fixpoint
        # (SERVING_COUNTS), so they all lower cold
        assert replayed > 0 or (tenant, renaming) == ("wave", True)
        np.testing.assert_array_equal(got, off, err_msg=f"run {rep}")


def _unordered_after_previous_epoch(srv, tenant):
    """Window ``m`` of ``tenant`` -> (instructions of ``m``, over all nodes,
    with no path from window ``m - 1``'s epoch in the captured schedule;
    instructions of ``m``)."""
    counts = {}
    for stream in srv.verifier.streams:
        dependents, epoch, members = {}, {}, {}
        for s in stream:
            for d, _ in s.deps:
                dependents.setdefault(d, []).append(s.instr.iid)
            i = s.instr
            if i.tenant == tenant and getattr(i, "window", None) is not None:
                members.setdefault(i.window, []).append(i.iid)
                if i.itype == port_core.InstructionType.EPOCH:
                    epoch[i.window] = i.iid
        for m, iids in members.items():
            if m - 1 not in epoch:
                continue
            after, todo = set(), [epoch[m - 1]]
            while todo:
                for x in dependents.get(todo.pop(), ()):
                    if x not in after:
                        after.add(x)
                        todo.append(x)
            c = counts.setdefault(m, [0, 0])
            c[0] += sum(iid not in after for iid in iids)
            c[1] += len(iids)
    return counts


@pytest.mark.parametrize("tenant,renaming", [("wave", False),
                                             ("nbody", False),
                                             ("nbody", True)])
@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_replay_keeps_overlap(depth, tenant, renaming):
    """Pipelining survives the fix: at depth 2 a steady replay of WaveSim
    or the N-body has no path from the previous window's epoch to any of
    its instructions but its own epochs (one a node, chained to the
    previous ones), so each may run beside the previous window as far as
    its hazard edges allow; at depth 1 every instruction has one."""
    from repro_torch.apps import serve_simulations
    u0, u1, P0, V0, dt, mass = _sim_inputs(64, 32, 64, 64)
    with port_core.ServingRuntime(2, 2, device="cpu", memo=True,
                                  renaming=renaming, verify="final",
                                  max_inflight_windows=depth) as srv:
        serve_simulations(srv, u0, u1, P0, V0, wave_windows=40,
                          nbody_windows=10, dt=dt, mass=mass)
        assert srv.verify_now().ok
        assert srv.tenants[tenant].replayed_windows > 0
        counts = _unordered_after_previous_epoch(srv, tenant)
    # the steady windows: the last three replays (the last window of each
    # tenant is the gather)
    steady = [counts[m] for m in sorted(counts)[-4:-1]]
    nodes = 2
    for free, total in steady:
        assert free == (0 if depth == 1 else total - nodes), counts
