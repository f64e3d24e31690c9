"""The cases of ``tests/test_system.py`` on the torch port's runtime, on the
CPU (``device="cpu"``): the three paper applications on the full concurrent
runtime (main thread, scheduler threads, executors, backend lanes) across
rank x device grids, held to numpy oracles, and the debug facilities
(uninitialised reads, overlapping writes, bounds checks, straggler report).
Where a case reads a count (RSim's allocations, the instruction totals of
the N-body), the same program on the JAX package's runtime must give the
same count.  ``tests/test_torch_gpu.py`` runs the scheduler-overlap case on
a card's streams.
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core import (BoundsError, Box, all_range, fixed,
                              neighborhood, one_to_one, read, read_write,
                              write)
from repro_torch.core.region import Region
from repro_torch.core.task_graph import TaskType
from torch_parity import keep_reference_ids  # noqa: F401

GRIDS = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 2)]


def Runtime(*args, api=port_core, **kw):
    """``api``'s runtime; the port's on the CPU."""
    if api is port_core:
        kw["device"] = "cpu"
    return api.Runtime(*args, **kw)


# -- N-body (paper listing 1 / fig. 2 / fig. 4) ------------------------------
def nbody_oracle(P0, V0, steps, dt=0.01, M=1.0):
    P, V = P0.copy(), V0.copy()
    for _ in range(steps):
        d = P[None, :, :] - P[:, None, :]
        r2 = (d * d).sum(-1) + 1e-3
        F = (d / r2[..., None] ** 1.5).sum(1)
        V = V + M * F * dt
        P = P + V * dt
    return P, V


def run_nbody(num_nodes, devs, N=48, steps=3, lookahead=True, dt=0.01, M=1.0,
              api=port_core):
    """The N-body on ``api``'s runtime: (gathered P and V), the oracle's,
    and the instruction total."""
    a = api
    rng = np.random.default_rng(7)
    P0 = rng.normal(size=(N, 3))
    V0 = rng.normal(size=(N, 3)) * 0.1
    with Runtime(num_nodes=num_nodes, devices_per_node=devs,
                 lookahead=lookahead, api=api) as rt:
        P = rt.buffer((N, 3), init=P0, name="P")
        V = rt.buffer((N, 3), init=V0, name="V")

        def timestep(chunk, p_view, v_view):
            Pa = p_view.get(a.Box((0, 0), (N, 3)))
            d = Pa[None, :, :] - Pa[chunk.min[0]:chunk.max[0], None, :]
            r2 = (d * d).sum(-1) + 1e-3
            F = (d / r2[..., None] ** 1.5).sum(1)
            v_view.set(chunk, v_view.get(chunk) + M * F * dt)

        def update(chunk, v_view, p_view):
            p_view.set(chunk, p_view.get(chunk) + v_view.get(chunk) * dt)

        for _ in range(steps):
            rt.submit("timestep", (N, 3),
                      [a.read(P, a.all_range()),
                       a.read_write(V, a.one_to_one())], timestep)
            rt.submit("update", (N, 3),
                      [a.read(V, a.one_to_one()),
                       a.read_write(P, a.one_to_one())], update)
        Pg, Vg = rt.gather(P), rt.gather(V)
        assert rt.warnings == []
        total = rt.total_instructions()
    return (Pg, Vg), nbody_oracle(P0, V0, steps, dt, M), total


@pytest.mark.parametrize("nodes,devs", GRIDS)
def test_nbody(nodes, devs):
    (Pg, Vg), (Pe, Ve), total = run_nbody(nodes, devs)
    np.testing.assert_allclose(Pg, Pe, atol=1e-10)
    np.testing.assert_allclose(Vg, Ve, atol=1e-10)
    assert total == run_nbody(nodes, devs, api=ref_core)[2]


def test_nbody_without_lookahead_matches():
    (Pg, Vg), (Pe, Ve), total = run_nbody(2, 2, lookahead=False)
    np.testing.assert_allclose(Pg, Pe, atol=1e-10)
    assert total == run_nbody(2, 2, lookahead=False, api=ref_core)[2]


# -- WaveSim: 5-point stencil (paper §5) --------------------------------------
def wavesim_oracle(u0, u1, steps, c=0.25):
    um, u = u0.copy(), u1.copy()
    for _ in range(steps):
        lap = (np.roll(u, 1, 0) + np.roll(u, -1, 0) +
               np.roll(u, 1, 1) + np.roll(u, -1, 1) - 4 * u)
        un = 2 * u - um + c * lap
        un[0, :] = un[-1, :] = un[:, 0] = un[:, -1] = 0.0
        um, u = u, un
    return u


@pytest.mark.parametrize("nodes,devs", [(1, 1), (2, 2), (4, 1)])
def test_wavesim(nodes, devs, H=32, W=24, steps=4):
    rng = np.random.default_rng(3)
    u0 = np.zeros((H, W))
    u1 = rng.normal(size=(H, W)) * 0.01
    u1[0, :] = u1[-1, :] = u1[:, 0] = u1[:, -1] = 0.0
    c = 0.25

    def step_kernel(chunk, um_v, u_v, un_v):
        lo, hi = chunk.min[0], chunk.max[0]
        ext = Box((max(0, lo - 1), 0), (min(H, hi + 1), W))
        u = u_v.get(ext)
        um = um_v.get(chunk)
        pad = lo - ext.min[0]
        out = torch.empty((hi - lo, W), dtype=u.dtype)
        for r in range(hi - lo):
            g = r + pad
            gi = lo + r
            if gi == 0 or gi == H - 1:
                out[r] = 0.0
                continue
            row = u[g]
            lap = (u[g - 1] + u[g + 1] + torch.roll(row, 1)
                   + torch.roll(row, -1) - 4 * row)
            out[r] = 2 * row - um[r] + c * lap
            out[r, 0] = out[r, -1] = 0.0
        un_v.set(chunk, out)

    with Runtime(num_nodes=nodes, devices_per_node=devs) as rt:
        B = [rt.buffer((H, W), init=u0, name="um"),
             rt.buffer((H, W), init=u1, name="u"),
             rt.buffer((H, W), init=np.zeros((H, W)), name="un")]
        for s in range(steps):
            um, u, un = B[s % 3], B[(s + 1) % 3], B[(s + 2) % 3]
            rt.submit(f"wave{s}", (H, W),
                      [read(um, one_to_one()), read(u, neighborhood((1, 0))),
                       write(un, one_to_one())], step_kernel)
        result = rt.gather(B[(steps + 1) % 3])
        assert rt.warnings == []
    np.testing.assert_allclose(result, wavesim_oracle(u0, u1, steps, c),
                               atol=1e-10)


# -- RSim: growing access pattern (paper §4.3/§5) -----------------------------
def row_cols(t, api=port_core):
    """Write mapper: row ``t``, columns one-to-one with the chunk (so the
    per-device writer sets stay disjoint under a column split)."""
    region = Region if api is port_core else ref_core.Region

    def rm(chunk, shape):
        return region.from_box(api.Box((t, chunk.min[1]),
                                       (t + 1, chunk.max[1])))

    rm.__name__ = f"row_cols({t})"
    return rm


def run_rsim(nodes, devs, lookahead, T=10, W=16, api=port_core):
    a = api
    with Runtime(num_nodes=nodes, devices_per_node=devs,
                 lookahead=lookahead, api=api) as rt:
        R = rt.buffer((T, W), init=np.zeros((T, W)), name="R")
        for t in range(T):
            def radiosity(chunk, prev_v, row_v, t=t):
                if t == 0:
                    row = np.ones(W)
                else:
                    row = prev_v.get(a.Box((0, 0), (t, W))).sum(0) + 1.0
                row_v.set(a.Box((t, chunk.min[1]), (t + 1, chunk.max[1])),
                          row[chunk.min[1]:chunk.max[1]])
            rt.submit(f"rad{t}", a.Box((0, 0), (1, W)),
                      [a.read(R, a.fixed(a.Box((0, 0), (max(t, 1), W)))),
                       a.write(R, row_cols(t, api))],
                      radiosity, split_dims=(1,))
        out = rt.gather(R)
        allocs = rt.total_allocs()
    exp = np.zeros((T, W))
    exp[0] = 1.0
    for t in range(1, T):
        exp[t] = exp[:t].sum(0) + 1.0
    return out, exp, allocs


def test_rsim_lookahead_correct_and_alloc_free():
    out, exp, allocs_on = run_rsim(1, 2, lookahead=True)
    np.testing.assert_allclose(out, exp)
    out2, exp2, allocs_off = run_rsim(1, 2, lookahead=False)
    np.testing.assert_allclose(out2, exp2)
    assert allocs_on < allocs_off, "lookahead must elide resize allocations"
    assert allocs_on == run_rsim(1, 2, lookahead=True, api=ref_core)[2]
    assert allocs_off == run_rsim(1, 2, lookahead=False, api=ref_core)[2]


# -- debug facilities (paper §4.4) --------------------------------------------
def test_uninitialized_read_warning_runtime():
    with Runtime(1, 1) as rt:
        B = rt.buffer((8,), name="u")  # never initialized
        rt.submit("r", (8,), [read(B, one_to_one())], lambda c, v: None)
        rt.sync()
        assert any("uninitialized" in w for w in rt.warnings)


def test_overlapping_write_error_runtime():
    with Runtime(2, 1) as rt:
        B = rt.buffer((8,), name="o")
        rt.submit("bad", (8,), [write(B, all_range())],
                  lambda c, v: v.set(Box((0,), (8,)), 1.0))
        rt.sync()
        assert any("overlapping write" in w for w in rt.warnings)


def test_accessor_bounds_check():
    with Runtime(1, 1, check_bounds=True) as rt:
        B = rt.buffer((16,), init=np.zeros(16), name="b")

        def oob(chunk, v):
            v.get(Box((0,), (16,)))  # declared only one_to_one on chunk

        rt.submit("half", (8,), [read_write(B, one_to_one())], oob)
        with pytest.raises((RuntimeError, BoundsError)):
            rt.sync()


# -- scheduling/execution overlap (paper fig. 7) ------------------------------
def test_scheduler_overlaps_execution():
    import time
    with Runtime(1, 2, trace=True) as rt:
        B = rt.buffer((64,), init=np.zeros(64), name="B")

        def slowk(chunk, v):
            time.sleep(0.002)
            v.set(chunk, v.get(chunk) + 1)

        for i in range(30):
            rt.submit(f"k{i}", (64,), [read_write(B, one_to_one())], slowk)
        rt.sync()
        tr = rt.tracer
    lanes = tr.lanes()
    assert any(l.startswith("sched-") for l in lanes)
    assert any(".device" in l for l in lanes), lanes.keys()
    # overlap fraction is computable (magnitude asserted in benchmarks)
    assert tr.overlap_fraction("sched-N0", "N0.device") >= 0.0


# -- host tasks, epochs, gather -----------------------------------------------
def test_host_task_and_epoch():
    seen = []
    with Runtime(2, 1) as rt:
        B = rt.buffer((8,), init=np.arange(8.0), name="B")

        def host(chunk, v):
            seen.append((chunk.min[0], chunk.max[0]))

        rt.submit("h", (8,), [read(B, one_to_one())], host,
                  ttype=TaskType.HOST)
        rt.sync()
    assert sorted(seen) == [(0, 4), (4, 8)]


def test_many_buffers_many_tasks():
    """Stress: 8 buffers, 40 random copy tasks, 2x2 grid, vs mirror arrays."""
    rng = np.random.default_rng(5)
    n = 32
    with Runtime(2, 2) as rt:
        bufs = [rt.buffer((n,), init=np.zeros(n), name=f"b{i}")
                for i in range(8)]
        mirror = [np.zeros(n) for _ in range(8)]
        for step in range(40):
            i, j = rng.integers(0, 8, size=2)
            if i == j:
                continue

            def k(chunk, src, dst):
                dst.set(chunk, src.get(chunk) * 0.5 + 1.0)

            rt.submit(f"t{step}", (n,),
                      [read(bufs[i], one_to_one()),
                       write(bufs[j], one_to_one())], k)
            mirror[j] = mirror[i] * 0.5 + 1.0
        got = [rt.gather(b) for b in bufs]
    for g, m in zip(got, mirror):
        np.testing.assert_allclose(g, m)


# -- straggler detection hook -------------------------------------------------
def test_straggler_report():
    import time
    with Runtime(1, 2) as rt:
        B = rt.buffer((16,), init=np.zeros(16), name="B")

        def slow_on_high(chunk, v):
            if chunk.min[0] >= 8:
                time.sleep(0.01)
            v.set(chunk, v.get(chunk) + 1)

        for i in range(5):
            rt.submit(f"k{i}", (16,), [read_write(B, one_to_one())],
                      slow_on_high)
        rt.sync()
        rep = rt.executors[0].straggler_report()
    assert any(k.startswith("device") for k in rep), rep
