"""The fault layer on the torch port, held against ``repro.core`` (the cases
of ``tests/test_faults.py``).

``FaultPlan``, the error taxonomy and ``run_with_restarts`` are copies; the
communicator's ack/retransmit transport, the executor's crash, straggler and
watchdog paths and ``Runtime.run_supervised`` are the port's own and carry
torch tensors.  Each program runs on the port on the CPU
(``device="cpu"``) with the kernels written in torch operations.  Results
under faults are held bitwise against the port's own fault-free run (the
oracle) and against the reference's run of the same program, with its numpy
kernels, within ``TOL``: |port - reference| <= 1e-12 + 1e-12 * |reference|
on float64 (the two sum the N-body force terms in other orders, which moves
the last bits).  Transport counters (messages, bytes, acks) of fault-free
runs must equal the reference's.

``pytest -m chaos`` also runs the seeded soak matrix, as the reference's
does; tier-1 deselects it.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core import (Box, ExecutionAborted, FaultPlan, Runtime,
                              neighborhood, one_to_one, read, read_write,
                              write)
from repro_torch.core.allocation import PINNED_HOST, Allocation
from repro_torch.core.backend import WorkItem
from repro_torch.core.communicator import Communicator, Payload, ReceiveArbiter
from repro_torch.core.executor import Executor
from repro_torch.core.faults import (InjectedCrash, NodeFailure,
                                     TransportError, run_with_restarts)
from repro_torch.core.instruction_graph import Instruction, InstructionType
from repro_torch.core.region import Region
from torch_parity import keep_reference_ids  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)


def _device(api):
    return {"device": "cpu"} if api is port_core else {}


def _is_torch(x):
    return isinstance(x, torch.Tensor)


# -- FaultPlan determinism ----------------------------------------------------
def test_fault_plan_replay_determinism():
    """Same seed => identical per-message decisions, equal in both
    packages; different seed differs somewhere; attempts re-roll."""
    keys = [((t, b), m, a) for t in range(8) for b in range(2)
            for m in range(4) for a in (1, 2)]
    kw = dict(drop=0.3, delay=0.3, duplicate=0.3, reorder=0.2)
    f1 = [FaultPlan(seed=42, **kw).payload_fate(t, m, a) for t, m, a in keys]
    fr = [ref_core.FaultPlan(seed=42, **kw).payload_fate(t, m, a)
          for t, m, a in keys]
    f3 = [FaultPlan(seed=43, **kw).payload_fate(t, m, a) for t, m, a in keys]
    fields = ("drop", "duplicate", "delay_s")
    assert ([tuple(getattr(f, k) for k in fields) for f in f1]
            == [tuple(getattr(f, k) for k in fields) for f in fr])
    assert f1 != f3
    assert any(f.drop for f in f1) and any(f.duplicate for f in f1)
    p1 = FaultPlan(seed=42, **kw)
    for t, m, _ in keys:
        assert not all(p1.payload_fate(t, m, a).drop for a in range(1, 30))


def test_fault_plan_survivors_clears_crash_only():
    p = FaultPlan(seed=1, drop=0.1, crash={1: 5}, slow={0: 0.01})
    s = p.survivors()
    assert s.crash == {} and s.drop == 0.1 and s.slow == {0: 0.01}
    assert p.crash_point(1) == 5 and s.crash_point(1) is None


# -- reliable transport units on tensor payloads ------------------------------
def _recv_setup(comm, tid, n=4):
    store = {}
    box = Box((0,), (n,))
    alloc = Allocation(mid=PINNED_HOST, bid=0, box=box)
    store[alloc.aid] = torch.full((n,), -1.0, dtype=torch.float64)
    arb = ReceiveArbiter(0, comm, store)
    recv = Instruction(InstructionType.RECEIVE, node=0, transfer_id=tid,
                       recv_region=Region.from_box(box), recv_alloc=alloc)
    recv.state = "issued"
    arb.begin(recv)
    return store, alloc, arb, recv, box


def test_retransmit_backoff_then_transport_error():
    plan = FaultPlan(seed=0, drop=1.0)
    comm = Communicator(2, fault_plan=plan, retransmit_timeout=0.002,
                        max_retries=3)
    comm.isend(0, Payload(1, 0, (1, 0), Box((0,), (1,)),
                          torch.ones(1, dtype=torch.float64)))
    assert comm.unacked(1) == 1
    failures = []
    deadline = time.monotonic() + 5.0
    while not failures and time.monotonic() < deadline:
        time.sleep(0.002)
        failures = comm.pump(1)
    assert len(failures) == 1
    assert isinstance(failures[0], TransportError)
    assert "unacked after" in str(failures[0]) and "tid=(1, 0)" in str(failures[0])
    assert comm.unacked(1) == 0
    assert comm.retries == 3
    assert comm.fault_counts["drop"] == 4
    assert comm.num_messages == 1 and comm.bytes_sent == 8


def test_drop_recovered_by_retransmit_bit_identical():
    tid = (2, 0)
    seed = next(s for s in range(500)
                if FaultPlan(seed=s, drop=0.5).payload_fate(tid, 0, 1).drop
                and not FaultPlan(seed=s, drop=0.5).payload_fate(tid, 0, 2).drop)
    comm = Communicator(2, fault_plan=FaultPlan(seed=seed, drop=0.5),
                        retransmit_timeout=0.002)
    store, alloc, arb, recv, box = _recv_setup(comm, tid)
    data = torch.arange(4.0, dtype=torch.float64)
    comm.isend(0, Payload(1, 0, tid, box, data))
    done = []
    deadline = time.monotonic() + 5.0
    while recv not in done and time.monotonic() < deadline:
        time.sleep(0.001)
        comm.pump(1)
        arb.step(done)
    assert recv in done
    assert torch.equal(store[alloc.aid], data)
    assert comm.fault_counts["drop"] >= 1 and comm.retries >= 1
    assert comm.num_messages == 1 and comm.retry_bytes >= 32
    comm.pump(1)
    assert comm.unacked(1) == 0


def test_duplicate_delivery_suppressed_and_acked():
    comm = Communicator(2, fault_plan=FaultPlan(seed=0, duplicate=1.0))
    store, alloc, arb, recv, box = _recv_setup(comm, (3, 0))
    comm.isend(0, Payload(1, 0, (3, 0), box,
                          torch.arange(4.0, dtype=torch.float64)))
    assert len(comm.payload_box[0]) == 2
    done = []
    arb.step(done)
    assert recv in done
    assert torch.equal(store[alloc.aid], torch.arange(4.0, dtype=torch.float64))
    assert arb.dups_suppressed == 1
    assert comm.acks == 2
    comm.pump(1)
    assert comm.unacked(1) == 0


def test_poisoned_tids_reject_late_payloads():
    comm = Communicator(2)
    store, alloc, arb, recv, box = _recv_setup(comm, (4, 0))
    assert arb.poison("test abort") == 1
    assert not arb.has_pending()
    comm.isend(0, Payload(1, 0, (4, 0), box,
                          torch.arange(4.0, dtype=torch.float64)))
    done = []
    arb.step(done)
    assert done == [] and arb.stale_rejected == 1
    assert torch.equal(store[alloc.aid],
                       torch.full((4,), -1.0, dtype=torch.float64))
    assert comm.acks == 1
    comm.pump(1)
    assert comm.unacked(1) == 0


def test_run_with_restarts_bounded():
    calls = []

    def attempt(restarts):
        calls.append(restarts)
        if len(calls) < 3:
            raise RuntimeError(f"boom {len(calls)}")
        return "ok"

    seen = []
    out, restarts = run_with_restarts(attempt, lambda e, r: seen.append(str(e)),
                                      max_restarts=3)
    assert out == "ok" and restarts == 2 and calls == [0, 1, 2]
    assert seen == ["boom 1", "boom 2"]
    with pytest.raises(RuntimeError, match="always"):
        run_with_restarts(lambda r: (_ for _ in ()).throw(RuntimeError("always")),
                          lambda e, r: None, max_restarts=1)


# -- programs under test (both packages) ------------------------------------
def nbody_oracle(P0, V0, steps, dt=0.01, M=1.0):
    P, V = P0.copy(), V0.copy()
    for _ in range(steps):
        d = P[None, :, :] - P[:, None, :]
        r2 = (d * d).sum(-1) + 1e-3
        F = (d / r2[..., None] ** 1.5).sum(1)
        V = V + M * F * dt
        P = P + V * dt
    return P, V


def _nbody_parts(api=port_core, N=32, dt=0.01, M=1.0):
    """Listing 1 as ``build``/``step`` for ``Runtime.run_supervised``; the
    kernels' operators run on tensors in the port and arrays in the
    reference."""
    rng = np.random.default_rng(7)
    P0 = rng.normal(size=(N, 3))
    V0 = rng.normal(size=(N, 3)) * 0.1

    def build(rt, init):
        snap = init if init is not None else {"P": P0, "V": V0}
        return {"P": rt.buffer((N, 3), init=snap["P"], name="P"),
                "V": rt.buffer((N, 3), init=snap["V"], name="V")}

    def step(rt, bufs, i):
        P, V = bufs["P"], bufs["V"]

        def timestep(chunk, p_view, v_view):
            Pa = p_view.get(api.Box((0, 0), (N, 3)))
            d = Pa[None, :, :] - Pa[chunk.min[0]:chunk.max[0], None, :]
            r2 = (d * d).sum(-1) + 1e-3
            F = (d / r2[..., None] ** 1.5).sum(1)
            v_view.set(chunk, v_view.get(chunk) + M * F * dt)

        def update(chunk, v_view, p_view):
            p_view.set(chunk, p_view.get(chunk) + v_view.get(chunk) * dt)

        rt.submit(f"timestep{i}", (N, 3),
                  [api.read(P, api.all_range()),
                   api.read_write(V, api.one_to_one())], timestep)
        rt.submit(f"update{i}", (N, 3),
                  [api.read(V, api.one_to_one()),
                   api.read_write(P, api.one_to_one())], update)

    return build, step, P0, V0


def run_nbody(nodes, devs, steps=3, api=port_core, **rt_kwargs):
    build, step, _, _ = _nbody_parts(api)
    with api.Runtime(num_nodes=nodes, devices_per_node=devs, **rt_kwargs,
                     **_device(api)) as rt:
        bufs = build(rt, None)
        for i in range(steps):
            step(rt, bufs, i)
        out = {k: rt.gather(b) for k, b in sorted(bufs.items())}
        stats = rt.comm_stats()
        assert rt.warnings == [], rt.warnings
    return out, stats


def _wave_kernel(api, H, W, c):
    """One wave step over the rows of a chunk: rows 0 and H - 1 and the
    first and last column stay zero.  The reference's loop per row as one
    vectorised step (torch on the port), in the same operation order."""
    def step_kernel(chunk, um_v, u_v, un_v):
        lo, hi = chunk.min[0], chunk.max[0]
        ext = api.Box((max(0, lo - 1), 0), (min(H, hi + 1), W))
        u, um = u_v.get(ext), um_v.get(chunk)
        xp = torch if _is_torch(u) else np
        out = xp.zeros((hi - lo, W), dtype=u.dtype)
        a, b = max(lo, 1), min(hi, H - 1)
        if a < b:
            o = ext.min[0]
            row = u[a - o:b - o]
            if xp is torch:
                left, right = torch.roll(row, 1, 1), torch.roll(row, -1, 1)
            else:
                left, right = np.roll(row, 1, 1), np.roll(row, -1, 1)
            lap = (u[a - 1 - o:b - 1 - o] + u[a + 1 - o:b + 1 - o] + left
                   + right - 4 * row)
            out[a - lo:b - lo] = 2 * row - um[a - lo:b - lo] + c * lap
            out[:, 0] = 0.0
            out[:, -1] = 0.0
        un_v.set(chunk, out)
    return step_kernel


def run_wavesim(nodes, devs, H=16, W=12, steps=3, api=port_core, **rt_kwargs):
    rng = np.random.default_rng(3)
    u0 = np.zeros((H, W))
    u1 = rng.normal(size=(H, W)) * 0.01
    u1[0, :] = u1[-1, :] = u1[:, 0] = u1[:, -1] = 0.0
    kernel = _wave_kernel(api, H, W, 0.25)
    with api.Runtime(num_nodes=nodes, devices_per_node=devs, **rt_kwargs,
                     **_device(api)) as rt:
        B = [rt.buffer((H, W), init=u0, name="um"),
             rt.buffer((H, W), init=u1, name="u"),
             rt.buffer((H, W), init=np.zeros((H, W)), name="un")]
        for s in range(steps):
            um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
            rt.submit(f"wave{s}", (H, W),
                      [api.read(um, api.one_to_one()),
                       api.read(u, api.neighborhood((1, 0))),
                       api.write(un, api.one_to_one())], kernel)
        out = {"u": rt.gather(B[(steps + 1) % 3])}
        stats = rt.comm_stats()
        assert rt.warnings == [], rt.warnings
    return out, stats


def run_allreduce(nodes, devs, n=97, api=port_core, **rt_kwargs):
    rng = np.random.default_rng(23)
    data = rng.normal(size=n) * 10.0 ** rng.integers(-12, 12, size=n)
    vdata = rng.normal(size=(n, 3))
    with api.Runtime(num_nodes=nodes, devices_per_node=devs, host_threads=2,
                     **rt_kwargs, **_device(api)) as rt:
        X = rt.buffer((n,), init=data, name="X")
        E = rt.buffer((1,), init=np.zeros(1), name="E")
        Y = rt.buffer((n, 3), init=vdata, name="Y")
        W = rt.buffer((3,), init=np.zeros(3), name="W")

        def ke(chunk, xv, red):
            red.contribute(xv.get(chunk))

        def kw(chunk, yv, red):
            red.contribute(yv.get(api.Box((chunk.min[0], 0),
                                          (chunk.max[0], 3))))

        rt.submit("e", (n,), [api.read(X, api.one_to_one()),
                              api.reduction(E, "sum")], ke)
        rt.submit("w", (n, 3), [api.read(Y, api.one_to_one()),
                                api.reduction(W, "sum")], kw)
        out = {"E": rt.gather(E), "W": rt.gather(W)}
        stats = rt.comm_stats()
        assert rt.warnings == [], rt.warnings
    return out, stats


PROGRAMS = {"nbody": run_nbody, "wavesim": run_wavesim,
            "allreduce": run_allreduce}
_oracles: dict = {}


def oracle(prog, nodes, devs, api=port_core):
    """The fault-free run of ``prog`` (values and comm stats), cached."""
    key = (prog, nodes, devs, api.__name__)
    if key not in _oracles:
        _oracles[key] = PROGRAMS[prog](nodes, devs, api=api)
    return _oracles[key]


def _hold(out, prog, nodes, devs):
    """Bitwise against the port's fault-free run; within TOL of the
    reference's."""
    port, _ = oracle(prog, nodes, devs)
    ref, _ = oracle(prog, nodes, devs, api=ref_core)
    for k in port:
        np.testing.assert_array_equal(out[k], port[k], err_msg=f"{prog} {k}")
        np.testing.assert_allclose(out[k], ref[k], **TOL, err_msg=f"{prog} {k}")


# -- fault-free invariants ----------------------------------------------------
def test_zero_fault_transport_invariants():
    out, stats = run_nbody(2, 1)
    _hold(out, "nbody", 2, 1)
    assert stats["retries"] == 0 and stats["retry_bytes"] == 0
    assert stats["dups_suppressed"] == 0 and stats["stale_rejected"] == 0
    assert stats["aborts"] == 0
    assert all(v == 0 for v in stats["faults_injected"].values())
    assert stats["messages"] > 0 and stats["acks"] == stats["messages"]
    ref_stats = oracle("nbody", 2, 1, api=ref_core)[1]
    for k in ("messages", "bytes", "acks"):
        assert stats[k] == ref_stats[k], k


def test_unreliable_opt_out_still_correct():
    out, stats = run_nbody(2, 1, reliable=False)
    _hold(out, "nbody", 2, 1)
    assert stats["acks"] == 0 and stats["retries"] == 0


def test_wire_faults_require_reliable_transport():
    with pytest.raises(ValueError, match="reliable"):
        Communicator(2, reliable=False, fault_plan=FaultPlan(drop=0.1))


def test_fault_smoke_bit_identical():
    plan = FaultPlan(seed=5, drop=0.08, duplicate=0.08, delay=0.08,
                     delay_s=0.004, pilot_drop=0.2)
    out, stats = run_wavesim(2, 2, fault_plan=plan, retransmit_timeout=0.01)
    _hold(out, "wavesim", 2, 2)
    injected = stats["faults_injected"]
    assert sum(injected.values()) > 0, injected
    assert stats["retries"] >= injected["drop"]
    assert stats["acks"] >= stats["messages"]
    clean = oracle("wavesim", 2, 2)[1]
    assert (stats["messages"], stats["bytes"]) == (clean["messages"],
                                                   clean["bytes"])


# -- crash attribution, watchdog, teardown ------------------------------------
def _crash_program(rt, H=12, W=8):
    u = rt.buffer((H, W), init=np.ones((H, W)), name="u")
    v = rt.buffer((H, W), init=np.zeros((H, W)), name="v")

    def k(chunk, uv, vv):
        lo, hi = chunk.min[0], chunk.max[0]
        ext = Box((max(0, lo - 1), 0), (min(H, hi + 1), W))
        vv.set(chunk, uv.get(ext)[lo - ext.min[0]:lo - ext.min[0] + hi - lo])

    for s in range(4):
        a, b = (u, v) if s % 2 == 0 else (v, u)
        rt.submit(f"k{s}", (H, W),
                  [read(a, neighborhood((1, 0))), write(b, one_to_one())], k)


def test_crashed_rank_attributed_quickly():
    plan = FaultPlan(crash={1: 8})
    rt = Runtime(num_nodes=2, devices_per_node=1, device="cpu",
                 fault_plan=plan, watchdog_timeout=0.3)
    try:
        _crash_program(rt)
        t0 = time.monotonic()
        with pytest.raises(ExecutionAborted) as ei:
            rt.sync(timeout=30.0)
        elapsed = time.monotonic() - t0
    finally:
        rt.shutdown()
    assert elapsed < 2.0, f"attribution took {elapsed:.2f}s"
    msg = str(ei.value)
    assert "N1" in msg and "InjectedCrash" in msg
    failures = dict(ei.value.failures)
    assert isinstance(failures[1], InjectedCrash)
    if 0 in failures:
        assert isinstance(failures[0], NodeFailure)
        assert 1 in failures[0].dead_peers
    assert rt.executors[1].crashed


def test_crash_teardown_releases_tensors():
    """After an aborted run, ``shutdown`` drops every tensor the executors
    still hold and every payload left on the wire, with the garbage
    collector off: on a card their memory returns at once."""
    plan = FaultPlan(crash={1: 8})
    rt = Runtime(2, 2, device="cpu", fault_plan=plan, watchdog_timeout=0.3)
    gc.disable()
    try:
        _crash_program(rt)
        with pytest.raises(ExecutionAborted):
            rt.sync(timeout=30.0)
        held = [weakref.ref(t) for ex in rt.executors
                for t in ex.store.values() if _is_torch(t)]
        wire = [weakref.ref(p.data) for box in rt.comm.payload_box
                for p in box if _is_torch(p.data)]
        wire += [weakref.ref(e.payload.data) for out in rt.comm._outstanding
                 for e in out.values() if _is_torch(e.payload.data)]
        assert held
        rt.shutdown()
        assert rt.thread_report()["total_leaked"] == 0
        assert all(r() is None for r in held + wire)
        assert all(not ex.store for ex in rt.executors)
        assert not any(rt.comm.payload_box) and not any(rt.comm._outstanding)
    finally:
        gc.enable()
        rt.shutdown()


def test_watchdog_clean_run_never_fires():
    out, stats = run_nbody(2, 1, watchdog_timeout=5.0)
    _hold(out, "nbody", 2, 1)
    assert stats["aborts"] == 0


def test_watchdog_waits_for_a_busy_lane():
    """A node whose lane runs one instruction longer than the watchdog's
    deadline (on a card: a copy into a large pinned allocation) is not
    stuck; the watchdog fires only on a node with nothing on its lanes."""
    with Runtime(1, 1, device="cpu", watchdog_timeout=0.2) as rt:
        B = rt.buffer((8,), init=np.zeros(8), name="B")

        def slow(chunk, v):
            time.sleep(0.6)
            v.set(chunk, v.get(chunk) + 1)

        rt.submit("slow", (8,), [read_write(B, one_to_one())], slow)
        np.testing.assert_array_equal(rt.gather(B), np.ones(8))
        assert not rt.executors[0].errors


def test_slow_rank_completes_correctly():
    out, _ = run_nbody(2, 1, fault_plan=FaultPlan(slow={1: 0.002}))
    _hold(out, "nbody", 2, 1)


# -- supervised elastic restart ----------------------------------------------
def _supervised_oracle(steps):
    _, _, P0, V0 = _nbody_parts()
    clean = Runtime.run_supervised(*_nbody_parts()[:2], steps=steps,
                                   num_nodes=2, checkpoint_every=steps,
                                   watchdog_timeout=None, device="cpu")
    ref = ref_core.Runtime.run_supervised(*_nbody_parts(ref_core)[:2],
                                          steps=steps, num_nodes=2,
                                          checkpoint_every=steps,
                                          watchdog_timeout=None)
    return clean.results, ref.results, nbody_oracle(P0, V0, steps)


def test_run_supervised_no_faults():
    build, step, _, _ = _nbody_parts()
    res = Runtime.run_supervised(build, step, steps=4, num_nodes=2,
                                 checkpoint_every=2, watchdog_timeout=None,
                                 device="cpu")
    clean, ref, (Pe, Ve) = _supervised_oracle(4)
    assert res.restarts == 0 and res.world == 2 and res.steps == 4
    for k, want in (("P", Pe), ("V", Ve)):
        np.testing.assert_array_equal(res.results[k], clean[k])
        np.testing.assert_allclose(res.results[k], ref[k], **TOL)
        np.testing.assert_allclose(res.results[k], want, **TOL)


def test_run_supervised_crash_restart_bit_identical():
    build, step, _, _ = _nbody_parts()
    res = Runtime.run_supervised(build, step, steps=4, num_nodes=2,
                                 checkpoint_every=1,
                                 fault_plan=FaultPlan(crash={1: 30}),
                                 watchdog_timeout=0.3, sync_timeout=30.0,
                                 device="cpu")
    clean, ref, _ = _supervised_oracle(4)
    assert res.restarts == 1, res
    assert res.world == 1
    for k in ("P", "V"):
        np.testing.assert_array_equal(res.results[k], clean[k])
        np.testing.assert_allclose(res.results[k], ref[k], **TOL)


def test_run_supervised_exhausts_restarts():
    def build(rt, init):
        return {"B": rt.buffer((4,), init=np.zeros(4), name="B")}

    def step(rt, bufs, i):
        def bad(chunk, v):
            raise RuntimeError("injected permanent failure")
        rt.submit(f"s{i}", (4,), [read_write(bufs["B"], one_to_one())], bad)

    with pytest.raises(ExecutionAborted, match="permanent failure"):
        Runtime.run_supervised(build, step, steps=1, num_nodes=1,
                               max_restarts=1, watchdog_timeout=None,
                               device="cpu")


# -- shutdown hygiene ---------------------------------------------------------
def test_shutdown_reports_leaked_threads():
    release = threading.Event()
    comm = Communicator(1)
    ex = Executor(0, 1, comm, device=torch.device("cpu"), host_threads=2)
    ex.backend.host_pool.submit(WorkItem(fn=lambda tag: release.wait(30.0)))
    time.sleep(0.05)
    ex.errors.append(RuntimeError("injected failure"))
    try:
        leaked = ex.shutdown()
        assert leaked >= 1
        assert ex.leaked_threads == leaked
        assert any("leak" in w or "join" in w for w in ex.warnings), ex.warnings
    finally:
        release.set()


def test_clean_shutdown_thread_report():
    with Runtime(2, 1, device="cpu") as rt:
        B = rt.buffer((8,), init=np.zeros(8), name="B")
        rt.submit("k", (8,), [read_write(B, one_to_one())],
                  lambda c, v: v.set(c, v.get(c) + 1))
        rt.sync()
        np.testing.assert_array_equal(rt.gather(B), np.ones(8))
    rep = rt.thread_report()
    assert rep["total_leaked"] == 0 and rep["warnings"] == []
    assert all(r["leaked_threads"] == 0 for r in rt.memory_report())


# -- chaos soak matrix (pytest -m chaos) --------------------------------------
CHAOS_GRIDS = [(2, 2), (3, 1)]
CHAOS_SEEDS_PER_CELL = 4


def _chaos_cases():
    cases = []
    for pi, prog in enumerate(sorted(PROGRAMS)):
        for gi, grid in enumerate(CHAOS_GRIDS):
            base = (pi * len(CHAOS_GRIDS) + gi) * CHAOS_SEEDS_PER_CELL
            for s in range(CHAOS_SEEDS_PER_CELL):
                cases.append((prog, grid, base + s))
    return cases


@pytest.mark.chaos
@pytest.mark.parametrize("prog,grid,seed", _chaos_cases())
def test_chaos_determinism(prog, grid, seed):
    nodes, devs = grid
    plan = FaultPlan(seed=seed, drop=0.05, duplicate=0.05, delay=0.05,
                     delay_s=0.004, reorder=0.05, reorder_s=0.001,
                     pilot_drop=0.15)
    out, stats = PROGRAMS[prog](nodes, devs, fault_plan=plan,
                                retransmit_timeout=0.01)
    _hold(out, prog, nodes, devs)
    injected = stats["faults_injected"]
    assert stats["retries"] >= injected["drop"]
    assert stats["acks"] >= stats["messages"]
    if injected["dup"]:
        assert stats["dups_suppressed"] > 0
    clean = oracle(prog, nodes, devs)[1]
    assert stats["messages"] == clean["messages"]
    assert stats["bytes"] == clean["bytes"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(100, 104))
def test_chaos_crash_plus_wire_faults_supervised(seed):
    build, step, _, _ = _nbody_parts()
    plan = FaultPlan(seed=seed, drop=0.04, duplicate=0.04, delay=0.04,
                     delay_s=0.003, crash={1: 20 + 7 * (seed % 4)})
    res = Runtime.run_supervised(build, step, steps=4, num_nodes=2,
                                 checkpoint_every=1, fault_plan=plan,
                                 watchdog_timeout=0.4, sync_timeout=30.0,
                                 retransmit_timeout=0.01, device="cpu")
    clean, ref, _ = _supervised_oracle(4)
    assert res.restarts <= 3
    for k in ("P", "V"):
        np.testing.assert_array_equal(res.results[k], clean[k])
        np.testing.assert_allclose(res.results[k], ref[k], **TOL)
