"""The port's memory budgets held against ``tests/test_memory.py``.

The runtime-level budget cases run the same phased program on the port's
runtime on the CPU (``device="cpu"``) and on ``repro.core``: results under a
budget are bit-identical to the unbudgeted run, the executor's real
per-memory peaks stay under the budget, and since the graph modules are
copies, the spill, reload and eviction counters and the instruction counts
equal the reference's under the same budget.  The structural cases compile
with the port's own ``IdagGenerator``.
"""

import math

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.core.allocation import device_memory
from repro_torch.core.buffer import VirtualBuffer
from repro_torch.core.command_graph import CommandType, generate_cdag
from repro_torch.core.instruction_graph import IdagGenerator, InstructionType
from repro_torch.core.task_graph import TaskGraph
from torch_parity import keep_reference_ids  # noqa: F401

N = 4096                      # per-buffer doubles -> 32768 bytes
BYTES = N * 8
QUIET = dict(retransmit_timeout=60.0)
COUNTERS = ("spills", "reloads", "evictions", "over_budget",
            "writeback_elisions")


def _phased_program(q, api, groups=3, revisit=True):
    """``tests/test_memory.py``'s program: ``groups`` disjoint (A, B) pairs
    touched in phases; phase 0 pauses around the others, so under a budget
    its buffers are spilled while dirty and reloaded."""
    rng = np.random.default_rng(7)
    bufs = [(q.buffer((N,), init=rng.normal(size=N), name=f"A{g}"),
             q.buffer((N,), init=np.zeros(N), name=f"B{g}"))
            for g in range(groups)]

    def steps(g, lo, hi):
        A, B = bufs[g]
        for s in range(lo, hi):
            def k(chunk, av, bv, s=s):
                bv.set(chunk, bv.get(chunk) + av.get(chunk) * (s + 1))
            q.submit(f"g{g}s{s}", (N,), [api.read(A, api.one_to_one()),
                                         api.read_write(B, api.one_to_one())],
                     k)

    if revisit:
        steps(0, 0, 3)
        for g in range(1, groups):
            steps(g, 0, 6)
        steps(0, 3, 6)
    else:
        for g in range(groups):
            steps(g, 0, 6)
    return [q.gather(B) for _, B in bufs]


def _device_peak(report):
    return max((v for k, v in report["real_peak"].items() if k >= 2),
               default=0)


def _run(api, nodes, devices, budget, **prog):
    extra = {"device": "cpu"} if api is port_core else {}
    with api.Runtime(nodes, devices, device_memory_budget=budget, **QUIET,
                     **extra) as q:
        out = _phased_program(q, api, **prog)
        reps = q.memory_report()
        instructions = q.total_instructions()
        warnings = q.warnings
    return out, reps, instructions, warnings


def _counters(reps):
    return {k: sum(r[k] for r in reps) for k in COUNTERS}


@pytest.mark.parametrize("nodes,devices,groups,revisit,share", [
    (1, 1, 3, True, 2),          # test_spill_reload_bitwise_oracle
    (1, 1, 6, False, 4),         # test_budget_quarter_of_working_set
    (2, 2, 3, True, 2)])         # test_budget_multi_node_multi_device
def test_budget_bitwise_under_budget_as_reference(nodes, devices, groups,
                                                  revisit, share):
    prog = dict(groups=groups, revisit=revisit)
    base, reps, _, _ = _run(port_core, nodes, devices, None, **prog)
    assert _counters(reps)["spills"] == _counters(reps)["reloads"] == 0
    budget = max(_device_peak(r) for r in reps) // share
    out, reps2, instrs, warnings = _run(port_core, nodes, devices, budget,
                                        **prog)
    assert warnings == []
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a, b)
    counters = _counters(reps2)
    assert counters["evictions"] > 0 and counters["over_budget"] == 0
    if revisit:
        assert counters["spills"] > 0 and counters["reloads"] > 0
    assert all(_device_peak(r) <= budget for r in reps2)
    assert all(v <= budget for r in reps2 for k, v in r["peak"].items()
               if k >= 2)
    exp, ref_reps, ref_instrs, _ = _run(ref_core, nodes, devices, budget,
                                        **prog)
    for a, b in zip(out, exp):
        np.testing.assert_array_equal(a, b)
    assert counters == _counters(ref_reps) and instrs == ref_instrs


def test_traced_memory_counters_match_executor_peaks():
    with port_core.Runtime(1, 1, device="cpu", device_memory_budget=2 * BYTES,
                           trace=True) as q:
        _phased_program(q, port_core)
        tracer = q.tracer
        ex_peaks = {f"N0.M{mid}.bytes": v
                    for mid, v in q.executors[0].mem_peak.items()}
    peaks = tracer.counter_peaks()
    assert peaks
    for name, v in ex_peaks.items():
        assert peaks.get(name) == v, (name, peaks.get(name), v)
    dev = {k: v for k, v in peaks.items() if ".M2." in k}
    assert dev and all(v <= 2 * BYTES for v in dev.values())


@pytest.mark.parametrize("steps", [1, 12])
def test_over_budget_fallback_and_warning_dedup(steps):
    """A budget below one kernel's working set: the run goes over budget
    with one deduplicated warning and the results stay right."""
    with port_core.Runtime(1, 1, device="cpu",
                           device_memory_budget=BYTES // 2) as q:
        A = q.buffer((N,), init=np.ones(N), name="A")
        B = q.buffer((N,), init=np.zeros(N), name="B")

        def k(chunk, av, bv):
            bv.set(chunk, av.get(chunk) + bv.get(chunk))

        for s in range(steps):
            q.submit(f"k{s}", (N,), [port_core.read(A, port_core.one_to_one()),
                                     port_core.read_write(
                                         B, port_core.one_to_one())], k)
        out = q.gather(B)
        rep = q.memory_report()[0]
        warnings = q.warnings
    np.testing.assert_array_equal(out, np.full(N, float(steps)))
    over = [w for w in warnings if "over budget" in w]
    assert rep["over_budget"] > 0 and len(over) == 1
    if rep["over_budget"] > 1:
        assert f"repeated {rep['over_budget']} times" in over[0]


def test_reduction_under_budget_bit_for_bit():
    """Reduction scratches count against the budget but are never evicted;
    a budgeted distributed sum equals the unbudgeted one and the fsum."""
    n = 8192
    data = np.random.default_rng(11).normal(size=n)

    def run(api, budget):
        extra = {"device": "cpu"} if api is port_core else {}
        with api.Runtime(2, 2, device_memory_budget=budget, **QUIET,
                         **extra) as rt:
            X = rt.buffer((n,), init=data, name="X")
            Y = rt.buffer((n,), init=data * 2, name="Y")
            E = rt.buffer((1,), init=np.zeros(1), name="E")

            def k(chunk, v, red):
                red.contribute(v.get(chunk))

            for name, buf in (("r1", X), ("r2", Y)):
                rt.submit(name, (n,), [api.read(buf, api.one_to_one()),
                                       api.reduction(E, "sum")], k)
            return float(rt.gather(E)[0]), rt.total_instructions()

    unbudgeted, _ = run(port_core, None)
    assert unbudgeted == math.fsum(data * 2)
    budgeted = run(port_core, n * 8)
    assert budgeted[0] == unbudgeted
    assert budgeted == run(ref_core, n * 8)


# -- structural cases on the port's IdagGenerator ----------------------------------------
def _compile(tdag, idag):
    gen = generate_cdag(tdag, 1)
    out = []
    for cmd in gen.commands[0]:
        if cmd.ctype == CommandType.EPOCH and cmd.task is None:
            continue
        out.extend(idag.compile(cmd))
    return out


def test_writeback_elision_clean_victim():
    """A victim coherent elsewhere is dropped without a SPILL copy, and the
    clean victim is preferred over a dirty, LRU-older one."""
    from repro_torch.core import one_to_one, read, write
    tdag = TaskGraph()
    A, B, C, D = (VirtualBuffer((N,), name=x) for x in "ABCD")
    tdag.submit("wA", (N,), [write(A, one_to_one())])
    tdag.submit("wB", (N,), [write(B, one_to_one())])
    tdag.submit("wC", (N,), [write(C, one_to_one())])
    tdag.submit("rA", (N,), [read(A, one_to_one())])
    tdag.submit("wD", (N,), [write(D, one_to_one())])
    idag = IdagGenerator(0, 1, budgets={device_memory(0): 2 * BYTES})
    _compile(tdag, idag)
    stats = idag.mem.stats
    kinds = [i.itype for i in idag.instructions]
    assert kinds.count(InstructionType.SPILL) == 2
    assert kinds.count(InstructionType.RELOAD) == 1
    assert (stats.evictions, stats.writeback_elisions, stats.elided_bytes) \
        == (3, 1, BYTES)
    freed = [i.allocation.bid for i in idag.instructions
             if i.itype == InstructionType.FREE
             and i.allocation.mid == device_memory(0)]
    assert freed == [A.bid, B.bid, A.bid]


def test_writeback_elision_in_memory_report():
    with port_core.Runtime(1, 1, device="cpu") as q:
        _phased_program(q, port_core)
        rep = q.memory_report()[0]
    for key in ("writeback_elisions", "elided_bytes", "prefetched_reloads"):
        assert key in rep
    # no card: PyTorch's CUDA counts are absent, not zero
    assert rep["cuda_allocated"] is None and rep["cuda_max_allocated"] is None


def test_unbudgeted_stream_has_no_spill_instructions():
    from repro_torch.core import one_to_one, read_write, write
    tdag = TaskGraph()
    A, B = VirtualBuffer((N,), name="A"), VirtualBuffer((N,), name="B")
    tdag.submit("wA", (N,), [write(A, one_to_one())])
    tdag.submit("wB", (N,), [write(B, one_to_one())])
    tdag.submit("rA", (N,), [read_write(A, one_to_one())])
    idag = IdagGenerator(0, 1)
    _compile(tdag, idag)
    types = {i.itype for i in idag.instructions}
    assert InstructionType.SPILL not in types
    assert InstructionType.RELOAD not in types
    assert idag.mem.stats.evictions == 0
