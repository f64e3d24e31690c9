"""The schedule sanitizer and the DOT export on the torch port, held against
``repro.core`` (the static corpus and the runtime true negatives of
``tests/test_verify.py``).

``verify.py`` and ``dot.py`` are copies, so the same task graph lowered by
both packages must verify clean with equal reports, and render to the same
DOT text once the global id counters (task, command, instruction,
allocation and buffer ids, which differ between two packages in one
process) are renumbered by first appearance.  The runtime cases run the
port's ``Runtime`` and ``ServingRuntime`` on the CPU (``device="cpu"``) with
``verify="final"`` or ``"window"``: every executed window, memo-replay
clones included, must verify clean, and the results must equal the same
program's without the sanitizer.
"""

import re

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from torch_parity import keep_reference_ids  # noqa: F401

N = 32
GRIDS = [(1, 1), (2, 2), (3, 1)]
APIS = [ref_core, port_core]


def _roll(x, k):
    return torch.roll(x, k) if isinstance(x, torch.Tensor) else np.roll(x, k)


# -- corpus: statically lowered programs (no execution) ----------------------
def _lower(api, tdag, nodes, devs, *, renaming=False, collectives=False,
           budgets=None):
    gen = api.generate_cdag(tdag, nodes, collectives=collectives)
    node_instrs, pilots, peaks = [], [], []
    for n in range(nodes):
        idag = api.IdagGenerator(n, devs, renaming=renaming, budgets=budgets)
        for cmd in gen.commands[n]:
            if cmd.ctype == api.CommandType.EPOCH and cmd.task is None:
                continue
            idag.compile(cmd)
        node_instrs.append(idag.instructions)
        pilots.extend(idag.pilots)
        peaks.append(dict(idag.mem.peak))
    return node_instrs, pilots, dict(budgets) if budgets else None, peaks


def _iterative_tdag(api, steps=6):
    tdag = api.TaskGraph(horizon_step=2)
    B = api.VirtualBuffer((N,), name="B", initial_value=np.zeros(N))
    C = api.VirtualBuffer((N,), name="C")
    for s in range(steps):
        tdag.submit(f"r{s}", (N,), [api.read(B, api.one_to_one()),
                                    api.write(C, api.one_to_one())])
        tdag.submit(f"w{s}", (N,), [api.write(B, api.one_to_one())])
    return tdag


def _wave_tdag(api, steps=6):
    tdag = api.TaskGraph(horizon_step=2)
    u0 = api.VirtualBuffer((N,), name="u0", initial_value=np.zeros(N))
    u1 = api.VirtualBuffer((N,), name="u1", initial_value=np.zeros(N))
    E = api.VirtualBuffer((1,), name="E", initial_value=np.zeros(1))
    cur, nxt = u0, u1
    for s in range(steps):
        tdag.submit(f"step{s}", (N,), [api.read(cur, api.all_range()),
                                       api.write(nxt, api.one_to_one())])
        tdag.submit(f"E{s}", (N,), [api.read(nxt, api.one_to_one()),
                                    api.reduction(E, "sum")])
        cur, nxt = nxt, cur
    return tdag


def _nbody_tdag(api, steps=4):
    tdag = api.TaskGraph(horizon_step=2)
    pos = api.VirtualBuffer((N,), name="pos", initial_value=np.zeros(N))
    frc = api.VirtualBuffer((N,), name="frc")
    for s in range(steps):
        tdag.submit(f"force{s}", (N,), [api.read(pos, api.all_range()),
                                        api.write(frc, api.one_to_one())])
        tdag.submit(f"euler{s}", (N,), [api.read(frc, api.one_to_one()),
                                        api.read_write(pos, api.one_to_one())])
    return tdag


def _halo_tdag(api, steps=5):
    tdag = api.TaskGraph(horizon_step=2)
    a = api.VirtualBuffer((N,), name="a", initial_value=np.zeros(N))
    b = api.VirtualBuffer((N,), name="b")
    cur, nxt = a, b
    for s in range(steps):
        tdag.submit(f"h{s}", (N,), [api.read(cur, api.neighborhood((2,))),
                                    api.write(nxt, api.one_to_one())])
        cur, nxt = nxt, cur
    return tdag


CORPUS = {"iter": _iterative_tdag, "wave": _wave_tdag, "nbody": _nbody_tdag}


def _verify_both(builder, nodes, devs, **kw):
    """Lower and verify ``builder``'s graph with both packages; the port's
    report must be clean and equal to the reference's."""
    reps = {}
    for api in APIS:
        ni, pi, vb, pk = _lower(api, builder(api), nodes, devs, **kw)
        rep = api.verify_graph(ni, pilots=pi, budgets=vb, peaks=pk)
        reps[api] = (rep.ok, rep.instructions, rep.pairs_checked,
                     len(rep.issues), ni)
    assert reps[port_core][:4] == reps[ref_core][:4]
    ok, instructions, pairs, _, ni = reps[port_core]
    assert ok and instructions > 0 and pairs > 0
    return ni


@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("nodes,devs", GRIDS)
@pytest.mark.parametrize("renaming", [False, True])
def test_corpus_static_clean(name, nodes, devs, renaming):
    _verify_both(CORPUS[name], nodes, devs, renaming=renaming)


@pytest.mark.parametrize("nodes,devs", [(2, 2), (3, 1)])
@pytest.mark.parametrize("renaming", [False, True])
def test_collective_corpus_static_clean(nodes, devs, renaming):
    ni = _verify_both(_wave_tdag, nodes, devs, renaming=renaming,
                      collectives=True)
    assert any(i.itype is port_core.InstructionType.COLL_SEND
               for s in ni for i in s)


@pytest.mark.parametrize("nodes,devs", [(2, 2), (3, 1)])
def test_halo_corpus_static_clean(nodes, devs):
    ni = _verify_both(_halo_tdag, nodes, devs)
    assert any(i.itype is port_core.InstructionType.SEND
               for s in ni for i in s)


@pytest.mark.parametrize("renaming", [False, True])
def test_budgeted_spill_static_clean(renaming):
    _ni, _pi, _vb, pk = _lower(port_core, _wave_tdag(port_core), 1, 1,
                               renaming=renaming)
    hwm = pk[0].get(port_core.device_memory(0), 0)
    assert hwm > 0
    budgets = {port_core.device_memory(0): max(hwm // 2, 512)}
    ni = _verify_both(_wave_tdag, 1, 1, renaming=renaming, budgets=budgets)
    assert any(i.itype in (port_core.InstructionType.SPILL,
                           port_core.InstructionType.RELOAD)
               for s in ni for i in s)


# -- DOT export -----------------------------------------------------------------
_IDS = re.compile(r"\b([tciTCIAB])(\d+)\b")


def _canonical(text: str) -> str:
    """Renumber global ids by first appearance, per prefix."""
    seen: dict[tuple, int] = {}

    def sub(m):
        key = (m.group(1).lower(), m.group(2))
        n = seen.setdefault(key, sum(k[0] == key[0] for k in seen))
        return f"{m.group(1)}{n}"
    return _IDS.sub(sub, text)


@pytest.mark.parametrize("nodes,devs", [(1, 1), (2, 2)])
def test_dot_export_equals_reference(nodes, devs):
    texts = {}
    for api in APIS:
        tdag = _wave_tdag(api)
        gen = api.generate_cdag(tdag, nodes, collectives=True)
        commands = [c for n in range(nodes) for c in gen.commands[n]]
        ni, _, _, _ = _lower(api, _wave_tdag(api), nodes, devs,
                             collectives=True)
        issues = api.verify_graph(ni).issues
        texts[api] = [_canonical(api.tdag_to_dot(tdag)),
                      _canonical(api.cdag_to_dot(commands)),
                      _canonical(api.idag_to_dot(ni, issues=issues))]
    assert texts[port_core] == texts[ref_core]
    assert all(t.startswith("digraph") for t in texts[port_core])


# -- true negatives: end to end under Runtime(verify=...) ------------------------
def _wave_program(q, steps=4):
    api = port_core
    rng = np.random.default_rng(11)
    u0 = q.buffer((N,), init=rng.normal(size=N), name="u0")
    u1 = q.buffer((N,), init=np.zeros(N), name="u1")
    E = q.buffer((1,), init=np.zeros(1), name="E")
    cur, nxt = u0, u1
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
        cur, nxt = nxt, cur
    return q.gather(cur), q.gather(E)


def _plain_wave(nodes, devs, **kw):
    with port_core.Runtime(nodes, devs, device="cpu", **kw) as q:
        return _wave_program(q)


@pytest.mark.parametrize("nodes,devs", GRIDS)
@pytest.mark.parametrize("mode,ren", [("final", False), ("window", True)])
def test_runtime_end_to_end_clean(nodes, devs, mode, ren):
    with port_core.Runtime(nodes, devs, device="cpu", renaming=ren,
                           verify=mode, issue_width=8 if ren else None,
                           max_inflight_windows=4 if ren else None) as q:
        got = _wave_program(q)
        q.sync()
        assert q.warnings == [], q.warnings
        assert q.verifier.issues == []
    for a, b in zip(got, _plain_wave(nodes, devs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [5, 7])
def test_runtime_chaos_clean(seed):
    plan = port_core.FaultPlan(seed=seed, drop=0.4, duplicate=0.2, delay=0.2)
    with port_core.Runtime(2, 2, device="cpu", fault_plan=plan,
                           verify="final") as q:
        got = _wave_program(q)
        q.sync()
        assert q.comm_stats()["retries"] > 0
    for a, b in zip(got, _plain_wave(2, 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("renaming", [False, True])
def test_runtime_budget_spill_clean(renaming):
    with port_core.Runtime(1, 1, device="cpu") as probe:
        base = _wave_program(probe)
        probe.sync()
        hwm = max(probe.memory_report()[0]["real_peak"].values())
    with port_core.Runtime(1, 1, device="cpu",
                           device_memory_budget=max(hwm // 2, 1024),
                           renaming=renaming, verify="final") as q:
        got = _wave_program(q)
        q.sync()
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)


def test_window_mode_emits_metrics():
    with port_core.Runtime(1, 1, device="cpu", verify="window") as q:
        _wave_program(q)
        q.sync()
        snap = q.metrics_registry.snapshot()
    hist = snap.get("histograms", {})
    assert "verify.window_us" in hist, sorted(hist)
    assert snap.get("counters", {}).get("verify.windows", 0) > 0


@pytest.mark.parametrize("depth", [1, 3])
def test_serving_replay_verifies_clean(depth):
    """Memo-replay clone windows (cross-window re-anchored deps, pipelined
    depth >= 2 with renaming) verify clean after drain; the instruction
    counts and memo stats equal the reference's."""
    out = {}
    for api in APIS:
        extra = {"device": "cpu"} if api is port_core else {}
        with api.ServingRuntime(1, 1, max_inflight_windows=depth,
                                renaming=depth > 1, verify="final",
                                **extra) as srv:
            t = srv.tenant("t0")
            u = t.buffer((N,), init=np.arange(N, dtype=float), name="u")
            for _w in range(8):
                def bump(chunk, uv):
                    uv.set(chunk, uv.get(chunk) + 1.0)

                t.submit("bump", (N,), [api.read_write(u, api.one_to_one())],
                         bump)
                t.run()
            t.drain()
            rep = srv.verify_now()
            assert rep.ok and rep.instructions > 0
            stats = srv.memo_stats()
            assert stats["hits"] > 0
            out[api] = (t.gather(u), rep.instructions, stats["hits"],
                        stats["misses"],
                        stats["tenants"]["t0"]["instructions"])
    assert out[port_core][1:] == out[ref_core][1:]
    np.testing.assert_array_equal(out[port_core][0],
                                  np.arange(N, dtype=float) + 8.0)
