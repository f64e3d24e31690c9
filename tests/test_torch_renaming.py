"""Allocation renaming, bounded in-flight windows and pipelined replay on the
torch port, held against ``repro.core`` (the cases of
``tests/test_renaming.py``).

Structural cases lower the same task graph with both packages' copies and
compare the instruction streams.  End-to-end cases run the same program on
both runtimes on the CPU (the port with ``device="cpu"``): the port's
renamed run must be bitwise equal to its own renaming-off run, and its
float64 values within ``RTOL`` = 1e-12 of the reference's (the kernels are
the same elementwise float64 operations and the sums are exact, so equality
is expected; the tolerance only allows for the port's torch kernels).  The
rename and allocation counts must be equal between the packages.

``test_renamed_allocations_stay_tensors`` is the regression test of fault
C2: a physical that renaming retires before its ALLOC has executed used to
come back as a host numpy array.
"""

import time

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core import InstructionType
from torch_parity import keep_reference_ids  # noqa: F401

N = 32
RTOL = 1e-12
GRIDS = [(1, 1), (2, 2), (3, 1)]
APIS = [ref_core, port_core]
_SYNC = (InstructionType.HORIZON, InstructionType.EPOCH)


def _device(api):
    return {"device": "cpu"} if api is port_core else {}


def _runtime(api, *args, **kw):
    return api.Runtime(*args, **kw, **_device(api))


def _serving(api, *args, **kw):
    return api.ServingRuntime(*args, **kw, **_device(api))


def _roll(x, k):
    return torch.roll(x, k) if isinstance(x, torch.Tensor) else np.roll(x, k)


# -- structural: renamed IDAGs carry no real anti-dependency edges ----------
def _compile(api, tdag, idag):
    gen = api.generate_cdag(tdag, 1)
    for cmd in gen.commands[0]:
        if cmd.ctype == api.CommandType.EPOCH and cmd.task is None:
            continue
        idag.compile(cmd)
    return idag.instructions


def _iterative_tdag(api, steps=6):
    tdag = api.TaskGraph(horizon_step=2)
    B = api.VirtualBuffer((N,), name="B", initial_value=np.zeros(N))
    C = api.VirtualBuffer((N,), name="C")
    for s in range(steps):
        tdag.submit(f"r{s}", (N,), [api.read(B, api.one_to_one()),
                                    api.write(C, api.one_to_one())])
        tdag.submit(f"w{s}", (N,), [api.write(B, api.one_to_one())])
    return tdag, B


def _hazard_edges(api, instrs):
    sync = (api.InstructionType.HORIZON, api.InstructionType.EPOCH)
    return [(i.name, d.name, k.value) for i in instrs
            for d, k in i.dependencies
            if k in (api.DepKind.ANTI, api.DepKind.OUTPUT)
            and i.itype not in sync and d.itype not in sync]


def _stream(instrs):
    return [(i.itype.value, i.name) for i in instrs]


def test_renamed_idag_has_no_anti_edges():
    out = {}
    for api in APIS:
        tdag, _ = _iterative_tdag(api)
        plain = _compile(api, tdag, api.IdagGenerator(0, 1))
        tdag, _ = _iterative_tdag(api)
        idag = api.IdagGenerator(0, 1, renaming=True)
        renamed = _compile(api, tdag, idag)
        out[api] = (_stream(plain), _hazard_edges(api, plain),
                    _stream(renamed), _hazard_edges(api, renamed),
                    idag.mem.stats.renames)
    assert out[port_core] == out[ref_core]
    _, plain_hz, _, renamed_hz, renames = out[port_core]
    assert plain_hz and renamed_hz == [] and renames > 0


def test_free_pool_bounds_physicals():
    out = {}
    for api in APIS:
        tdag, B = _iterative_tdag(api)
        idag = api.IdagGenerator(0, 1, renaming=True)
        instrs = _compile(api, tdag, idag)
        by_mid: dict = {}
        for i in instrs:
            if (i.itype == api.InstructionType.ALLOC
                    and i.allocation.bid == B.bid):
                by_mid[i.allocation.mid] = by_mid.get(i.allocation.mid, 0) + 1
        out[api] = (by_mid, idag.mem.stats.renames, idag.mem.stats.pool_hits)
    assert out[port_core] == out[ref_core]
    by_mid, renames, pool_hits = out[port_core]
    assert renames >= 6 and pool_hits > 0
    assert all(v <= 2 for v in by_mid.values()), by_mid


# -- end to end: bit-identical to the renaming-off oracle -------------------
def _wave_program(api, q, steps=6):
    """Rotating-buffer wave iteration with a per-step sum reduction; the
    all_range read forces cross-node exchange on multi-node grids."""
    rng = np.random.default_rng(11)
    u0 = q.buffer((N,), init=rng.normal(size=N), name="u0")
    u1 = q.buffer((N,), init=np.zeros(N), name="u1")
    E = q.buffer((1,), init=np.zeros(1), name="E")
    cur, nxt = u0, u1
    energies = []
    for s in range(steps):
        def step(chunk, uc, un, _s=s):
            ua = uc.get(api.Box((0,), (N,)))
            lo, hi = chunk.min[0], chunk.max[0]
            lap = _roll(ua, 1) + _roll(ua, -1) - 2.0 * ua
            un.set(chunk, (ua + 0.1 * lap + 0.01 * _s)[lo:hi])

        q.submit(f"step{s}", (N,), [api.read(cur, api.all_range()),
                                    api.write(nxt, api.one_to_one())], step)

        def esum(chunk, un, red):
            red.contribute(un.get(chunk))

        q.submit(f"E{s}", (N,), [api.read(nxt, api.one_to_one()),
                                 api.reduction(E, "sum")], esum)
        energies.append(float(q.gather(E)[0]))
        cur, nxt = nxt, cur
    return q.gather(cur), energies


def _wave_both(nodes, devs, **kw):
    """The wave program on both runtimes with ``kw``; the port's field and
    energies, the reference's, and each run's counts."""
    out = {}
    for api in APIS:
        with _runtime(api, nodes, devs, **kw) as q:
            field, energies = _wave_program(api, q)
            assert q.warnings == [], q.warnings
            counts = dict(renames=sum(r["renames"] for r in q.memory_report()),
                          instructions=q.total_instructions(),
                          allocs=q.total_allocs())
        out[api] = (field, energies, counts)
    return out[port_core], out[ref_core]


@pytest.mark.parametrize("nodes,devs", GRIDS)
def test_renaming_bit_identical_oracle(nodes, devs):
    base, _ = _wave_both(nodes, devs)
    got, exp = _wave_both(nodes, devs, renaming=True, issue_width=8,
                          max_inflight_windows=4)
    np.testing.assert_array_equal(got[0], base[0])
    assert got[1] == base[1]
    np.testing.assert_allclose(got[0], exp[0], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[1], exp[1], rtol=RTOL, atol=0)
    assert got[2] == exp[2] and got[2]["renames"] > 0


def test_renaming_bit_identical_under_chaos():
    plan = dict(seed=5, drop=0.4, duplicate=0.2, delay=0.2)
    with port_core.Runtime(2, 1, device="cpu") as q:
        base, e_base = _wave_program(port_core, q, steps=4)
    with port_core.Runtime(2, 1, device="cpu", renaming=True,
                           fault_plan=port_core.FaultPlan(**plan)) as q:
        out, e_out = _wave_program(port_core, q, steps=4)
        retries = q.comm_stats()["retries"]
    with ref_core.Runtime(2, 1, renaming=True,
                          fault_plan=ref_core.FaultPlan(**plan)) as q:
        exp, e_exp = _wave_program(ref_core, q, steps=4)
    np.testing.assert_array_equal(out, base)
    assert e_out == e_base
    np.testing.assert_allclose(out, exp, rtol=RTOL, atol=0)
    np.testing.assert_allclose(e_out, e_exp, rtol=RTOL, atol=0)
    assert retries > 0


def _phased_overwrites(api, q, groups=3, steps=4, n=4096):
    """``groups`` (A, B) pairs touched in phases; every step is a pure
    overwrite of B (a rename candidate), and phase 0 pauses around the
    others so its buffers face eviction while other phases run."""
    rng = np.random.default_rng(3)
    bufs = [(q.buffer((n,), init=rng.normal(size=n), name=f"A{g}"),
             q.buffer((n,), init=np.zeros(n), name=f"B{g}"))
            for g in range(groups)]

    def phase(g, lo, hi):
        A, B = bufs[g]
        for s in range(lo, hi):
            def k(chunk, av, bv, _s=s):
                bv.set(chunk, av.get(chunk) * (_s + 2))
            q.submit(f"g{g}s{s}", (n,), [api.read(A, api.one_to_one()),
                                         api.write(B, api.one_to_one())], k)

    phase(0, 0, steps // 2)
    for g in range(1, groups):
        phase(g, 0, steps)
    phase(0, steps // 2, steps)
    return [q.gather(B) for _, B in bufs]


def test_renamed_allocations_stay_tensors():
    """Fault C2.  One pair, six pure overwrites B = A * (s + 2) under
    renaming: every buffer allocation the kernels see is a tensor, and the
    bytes equal the renaming-off run's."""
    n, seen = 4096, set()
    a0 = np.random.default_rng(3).normal(size=n)

    def program(rt):
        A = rt.buffer((n,), init=a0, name="A")
        B = rt.buffer((n,), init=np.zeros(n), name="B")
        for s in range(6):
            def k(chunk, av, bv, _s=s):
                seen.update((type(av.array), type(bv.array)))
                bv.set(chunk, av.get(chunk) * (_s + 2))
            rt.submit(f"s{s}", (n,), [port_core.read(A, port_core.one_to_one()),
                                      port_core.write(B, port_core.one_to_one())],
                      k)
        return rt.gather(B)

    with port_core.Runtime(1, 1, device="cpu") as rt:
        base = program(rt)
    with port_core.Runtime(1, 1, device="cpu", renaming=True) as rt:
        got = program(rt)
        renames = rt.memory_report()[0]["renames"]
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(got, a0 * 7)
    assert renames > 0 and seen == {torch.Tensor}


def test_renaming_bit_identical_under_budget():
    """Under a 50% device budget, pooled physicals drain before spilling;
    bitwise equal to the unbudgeted renaming-off run, peaks under budget,
    and the same counts and peaks as the reference."""
    out = {}
    for api in APIS:
        with _runtime(api, 1, 1) as q:
            base = _phased_overwrites(api, q)
        with _runtime(api, 1, 1, renaming=True) as q:
            _phased_overwrites(api, q)
            hwm = q.device_peak_bytes()
        budget = hwm // 2
        with _runtime(api, 1, 1, renaming=True,
                      device_memory_budget=budget) as q:
            res = _phased_overwrites(api, q)
            rep = q.memory_report()[0]
            peak = q.device_peak_bytes()
            assert q.warnings == [], q.warnings
        for a, b in zip(base, res):
            np.testing.assert_array_equal(a, b)
        assert peak <= budget, (peak, budget)
        out[api] = (res, hwm, peak, {k: rep[k] for k in (
            "over_budget", "renames", "pool_frees", "spills", "reloads")})
    got, exp = out[port_core], out[ref_core]
    for a, b in zip(got[0], exp[0]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    assert got[1:] == exp[1:]
    counts = got[3]
    assert counts["over_budget"] == 0 and counts["renames"] > 0
    assert counts["pool_frees"] > 0


# -- serving: pipelined replay, LRU cap, pinned gather ----------------------
def _serve_burst(api, depth, windows=8, slow_s=0.002):
    """One tenant, two independent buffers: a fast kernel on X and a slow
    kernel on Y per window.  With depth >= 2 the next window's fast kernel
    overlaps the previous window's slow kernel."""
    with _serving(api, num_nodes=1, devices_per_node=1,
                  max_inflight_windows=depth) as srv:
        t = srv.tenant("t0", max_queued_windows=windows + 2)
        X = t.buffer((N,), name="X", init=np.zeros(N))
        Y = t.buffer((N,), name="Y", init=np.arange(N, dtype=np.float64))
        for w in range(windows):
            def fast(chunk, xv, _w=w):
                xv.set(chunk, xv.get(chunk) + (_w + 1))

            def slow(chunk, yv, _w=w):
                time.sleep(slow_s)
                yv.set(chunk, yv.get(chunk) * 1.5 - _w)

            t.submit("fast", (N,), [api.read_write(X, api.one_to_one())], fast)
            t.submit("slow", (N,), [api.read_write(Y, api.one_to_one())], slow)
            t.run()
        t.drain()
        x, y = t.gather(X), t.gather(Y)
        stats = srv.memo_stats()
    return x, y, stats


def test_pipelined_replay_bit_identical_and_deep():
    x1, y1, s1 = _serve_burst(port_core, depth=1)
    x2, y2, s2 = _serve_burst(port_core, depth=2)
    xr, yr, sr = _serve_burst(ref_core, depth=2)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_allclose(x2, xr, rtol=RTOL, atol=0)
    np.testing.assert_allclose(y2, yr, rtol=RTOL, atol=0)
    t1, t2 = s1["tenants"]["t0"], s2["tenants"]["t0"]
    for k in ("lowered", "replayed", "instructions"):
        assert t2[k] == sr["tenants"]["t0"][k], k
    assert t2["replayed"] > 0
    assert t1["window_peak"][0] == 1, t1["window_peak"]
    assert t2["window_peak"][0] >= 2, t2["window_peak"]


@pytest.mark.parametrize("api", APIS, ids=["reference", "port"])
def test_memo_cache_lru_cap(api):
    with _serving(api, num_nodes=1, devices_per_node=1,
                  memo_cache_max=2) as srv:
        t = srv.tenant("t0")
        A = t.buffer((N,), name="A", init=np.zeros(N))
        for _cycle in range(3):
            for name in ("ka", "kb", "kc"):
                def k(chunk, av, _n=name):
                    av.set(chunk, av.get(chunk) + len(_n))
                t.submit(name, (N,), [api.read_write(A, api.one_to_one())], k)
                t.run()
        t.drain()
        out = t.gather(A)
        stats = srv.memo_stats()
        assert len(t._memo) <= 2
    np.testing.assert_array_equal(out, np.full(N, 2.0 * 9))
    assert stats["evictions"] > 0 and stats["hits"] == 0


def test_pinned_gather_replays_and_stays_independent():
    with port_core.ServingRuntime(1, 1, device="cpu") as srv:
        t = srv.tenant("t0")
        A = t.buffer((N,), name="A", init=np.arange(N, dtype=np.float64))

        def bump(chunk, av):
            av.set(chunk, av.get(chunk) + 1.0)

        gathers = []
        for _w in range(5):
            t.submit("bump", (N,), [port_core.read_write(
                A, port_core.one_to_one())], bump)
            t.run()
            gathers.append(t.gather(A))
        assert len(t._gather_pins) == 1
        assert srv.memo_stats()["hits"] > 0
    for w, g in enumerate(gathers):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        np.testing.assert_array_equal(g, np.arange(N) + (w + 1))
    gathers[0][:] = -1.0
    np.testing.assert_array_equal(gathers[1], np.arange(N) + 2)


# -- issue width: the drain-pass cap is semantics-neutral -------------------
def test_issue_width_semantics_neutral():
    with port_core.Runtime(1, 2, device="cpu") as q:
        base, e_base = _wave_program(port_core, q, steps=4)
    with port_core.Runtime(1, 2, device="cpu", issue_width=1) as q:
        out, e_out = _wave_program(port_core, q, steps=4)
    np.testing.assert_array_equal(base, out)
    assert e_base == e_out


def test_renaming_bit_identical_on_every_program():
    """Every end-to-end program of ``tests/test_renaming.py`` on the port:
    renaming on gives the bytes of renaming off."""
    for nodes, devs in GRIDS:
        runs = []
        for ren in (False, True):
            with port_core.Runtime(nodes, devs, device="cpu",
                                   renaming=ren) as q:
                runs.append((_wave_program(port_core, q),
                             _phased_overwrites(port_core, q)))
        (w0, p0), (w1, p1) = runs
        np.testing.assert_array_equal(w0[0], w1[0])
        assert w0[1] == w1[1]
        for a, b in zip(p0, p1):
            np.testing.assert_array_equal(a, b)
