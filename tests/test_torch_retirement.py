"""The cases of ``tests/test_retirement.py`` on the torch port, on the CPU:
TDAG and CDAG prefixes are retired at horizons in runtime mode, so every
graph layer holds O(window) state on long programs while lifetime counters
keep the totals.  Each case also runs on the JAX package, and the retained
and lifetime counts must be equal.
"""

import numpy as np

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.buffer import VirtualBuffer as RefVirtualBuffer
from repro_torch.core.buffer import VirtualBuffer
from torch_parity import keep_reference_ids  # noqa: F401


def _runtime(api, *args, **kw):
    if api is port_core:
        kw["device"] = "cpu"
    return api.Runtime(*args, **kw)


def _vbuf(api, *args, **kw):
    return (VirtualBuffer if api is port_core else RefVirtualBuffer)(*args,
                                                                      **kw)


def _long_run(api, steps: int):
    with _runtime(api, num_nodes=2, devices_per_node=1) as rt:
        A = rt.buffer((64,), init=np.zeros(64), name="A")
        B = rt.buffer((64,), init=np.zeros(64), name="B")
        for s in range(steps):
            def k(chunk, av, bv, s=s):
                bv.set(chunk, bv.get(chunk) + av.get(chunk) + s)
            rt.submit(f"k{s}", (64,), [api.read(A, api.one_to_one()),
                                       api.read_write(B, api.one_to_one())],
                      k)
        rt.sync()
        tdag_retained = len(rt.tdag.tasks)
        tdag_total = rt.tdag.task_count
        cdag_retained = [len(s.cdag.commands[n]) for s in rt.schedulers
                         for n in range(rt.num_nodes)]
        cdag_total = [sum(s.cdag.emitted_counts) for s in rt.schedulers]
        out = rt.gather(B)
    return tdag_retained, tdag_total, cdag_retained, cdag_total, out


def test_long_run_bounded_tdag_cdag():
    """Retained task/command counts are O(horizon window), independent of
    program length; lifetime counters still see every emission.  Both
    packages count the same."""
    r60 = _long_run(port_core, 60)
    r240 = _long_run(port_core, 240)
    assert r240[1] > r60[1] >= 60
    assert min(r240[3]) > min(r60[3])
    assert r240[0] <= 32 and r60[0] <= 32
    assert max(r240[2]) <= 32 and max(r60[2]) <= 32
    assert r240[0] <= r60[0] + 4
    assert max(r240[2]) <= max(r60[2]) + 4
    np.testing.assert_array_equal(
        r240[4], np.full(64, sum(range(240)), dtype=float))
    for steps, got in ((60, r60), (240, r240)):
        assert got[:4] == _long_run(ref_core, steps)[:4], steps


def test_retirement_results_identical():
    """Bit-identical results from two runs of the retiring runtime."""
    def run(steps=40):
        with _runtime(port_core, num_nodes=1, devices_per_node=2) as rt:
            B = rt.buffer((32,), init=np.ones(32), name="B")
            for s in range(steps):
                def k(chunk, bv, s=s):
                    bv.set(chunk, bv.get(chunk) * 1.0001 + s * 1e-6)
                rt.submit(f"s{s}", (32,),
                          [port_core.read_write(B, port_core.one_to_one())],
                          k)
            return rt.gather(B)

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)


def _standalone(api):
    tdag = api.TaskGraph(horizon_step=2)
    B = _vbuf(api, (16,), name="B", initial_value=np.zeros(16))
    for i in range(20):
        tdag.submit(f"k{i}", (16,), [api.read_write(B, api.one_to_one())])
    gen = api.generate_cdag(tdag, 2)
    return (len(tdag.tasks), tdag.task_count,
            [len(cmds) for cmds in gen.commands], list(gen.emitted_counts))


def test_standalone_generators_do_not_retire():
    """Graphs built outside a runtime keep their full history (the
    retirement is opt-in via the runtime)."""
    retained, total, commands, emitted = got = _standalone(port_core)
    assert retained == total > 20
    assert commands == emitted
    assert all(n > 20 for n in commands)
    assert got == _standalone(ref_core)


def _retire_mode(api):
    tdag = api.TaskGraph(horizon_step=2)
    B = _vbuf(api, (16,), name="B", initial_value=np.zeros(16))
    for i in range(20):
        tdag.submit(f"k{i}", (16,), [api.write(B, api.one_to_one())])
    gen = api.CommandGraphGenerator(2, retire_for=0)
    for t in tdag.tasks:
        if t.name == "init":
            continue
        gen.process(t)
    return [len(cmds) for cmds in gen.commands], list(gen.emitted_counts)


def test_cdag_retire_mode_trims_and_counts():
    commands, emitted = got = _retire_mode(port_core)
    assert all(n <= 8 for n in commands)
    assert all(c > 20 for c in emitted)
    assert got == _retire_mode(ref_core)
