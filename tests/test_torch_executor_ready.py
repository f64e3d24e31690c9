"""The cases of ``tests/test_executor_ready.py`` on the torch port's executor
and runtime, on the CPU (``device="cpu"``).

The ready-queue contract: ready instructions issue at once and blocked ones
only after their last dependency completes; an instruction whose unfinished
dependencies all sit on one in-order device queue is issued eagerly;
horizons retire what completed, so the executor's tracking stays bounded.

Where a case reads a count (retired instructions, retained instructions,
total instructions), the same program runs on the JAX package's executor
and the counts must be equal.  The peak of registered instructions depends
on how the scheduler and executor threads interleave, in both packages, so
both peaks are held to the reference's bound instead of to each other.
The eager-issue case runs here on the CPU lanes; ``tests/test_torch_gpu.py``
runs it on a card's streams.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from torch_parity import keep_reference_ids  # noqa: F401

CPU = torch.device("cpu")


def _mods(api):
    """The executor-level modules of ``api`` (a package's ``core``)."""
    base = api.__name__
    return {m: importlib.import_module(f"{base}.{m}") for m in (
        "command_graph", "communicator", "executor", "instruction_graph",
        "task_graph")}


def _executor(api, comm, **kw):
    ex_cls = _mods(api)["executor"].Executor
    if api is port_core:
        kw["device"] = CPU
    return ex_cls(0, 1, comm, **kw)


def _runtime(api, *args, **kw):
    if api is port_core:
        kw["device"] = "cpu"
    return api.Runtime(*args, **kw)


class RecordingTracer:
    """Minimal tracer double: logs (event, name) in order, thread-safe."""

    def __init__(self):
        self.events: list[tuple[str, str]] = []
        self._lock = threading.Lock()

    def issue(self, node, instr):
        with self._lock:
            self.events.append(("issue", instr.name))

    def complete(self, node, instr):
        with self._lock:
            self.events.append(("complete", instr.name))

    def record(self, node, instr, lane, **stamps):
        self.complete(node, instr)

    def counter(self, name, value):
        pass

    def wait_for(self, event, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if event in self.events:
                    return True
            time.sleep(0.001)
        return False

    def snapshot(self):
        with self._lock:
            return list(self.events)


def _host_task(m, name, fn, deps=()):
    ig = m["instruction_graph"]
    i = ig.Instruction(ig.InstructionType.HOST_TASK, node=0, queue=("host",),
                       kernel_fn=fn, name=name)
    for d in deps:
        i.add_dependency(d, m["task_graph"].DepKind.TRUE)
    return i


def _device_kernel(m, name, fn, deps=(), device=0):
    ig = m["instruction_graph"]
    i = ig.Instruction(ig.InstructionType.DEVICE_KERNEL, node=0,
                       queue=("device", device), kernel_fn=fn, name=name,
                       device=device)
    for d in deps:
        i.add_dependency(d, m["task_graph"].DepKind.TRUE)
    return i


def _epoch(m, name="fin"):
    cg, ig = m["command_graph"], m["instruction_graph"]
    cmd = cg.Command(cg.CommandType.EPOCH, node=0)
    return ig.Instruction(ig.InstructionType.EPOCH, node=0, queue=("host",),
                          name=name, command=cmd), cmd


def test_ready_queue_order_skips_blocked_chain():
    """An independent instruction issues while a blocked dependent waits."""
    m = _mods(port_core)
    tracer = RecordingTracer()
    ex = _executor(port_core, m["communicator"].Communicator(1),
                   host_threads=2, tracer=tracer)
    gate = threading.Event()
    try:
        a = _host_task(m, "A", lambda chunk: gate.wait(5))
        b = _host_task(m, "B", lambda chunk: None, deps=[a])
        c = _host_task(m, "C", lambda chunk: None)
        ex.submit([a, b, c])
        assert tracer.wait_for(("issue", "A"))
        assert tracer.wait_for(("issue", "C"))
        assert tracer.wait_for(("complete", "C"))
        assert ("issue", "B") not in tracer.snapshot()
        gate.set()
        assert tracer.wait_for(("issue", "B"))
        ev = tracer.snapshot()
        assert ev.index(("issue", "B")) > ev.index(("complete", "A"))
        assert ev.index(("issue", "A")) < ev.index(("issue", "C"))
    finally:
        gate.set()
        ex.shutdown()


def test_eager_issue_on_single_in_order_queue():
    """A device instruction whose incomplete dep sits on one in-order queue
    is submitted eagerly, before the dep completes (§4.1)."""
    m = _mods(port_core)
    tracer = RecordingTracer()
    ex = _executor(port_core, m["communicator"].Communicator(1),
                   queues_per_device=2, host_threads=1, tracer=tracer)
    gate = threading.Event()
    try:
        a = _device_kernel(m, "A", lambda chunk: gate.wait(5))
        b = _device_kernel(m, "B", lambda chunk: None, deps=[a])
        ex.submit([a, b])
        assert tracer.wait_for(("issue", "A"))
        assert tracer.wait_for(("issue", "B"))
        ev = tracer.snapshot()
        assert ("complete", "A") not in ev, "eager issue happened too late"
        qa, qb = ex._issued_on.get(a.iid), ex._issued_on.get(b.iid)
        assert qa is not None and qa is qb
        gate.set()
        assert tracer.wait_for(("complete", "B"))
        ev = tracer.snapshot()
        assert ev.index(("complete", "A")) < ev.index(("complete", "B"))
    finally:
        gate.set()
        ex.shutdown()


def _horizon_program(api):
    """A chain of 20 host tasks, a horizon and a closing epoch on ``api``'s
    executor: (retained, retired, first task's dependents, sixth task's
    dependencies) after the epoch."""
    m = _mods(api)
    ig = m["instruction_graph"]
    ex = _executor(api, m["communicator"].Communicator(1), host_threads=2,
                   tracer=RecordingTracer())
    try:
        tasks = [_host_task(m, "t0", lambda chunk: None)]
        for k in range(1, 20):
            tasks.append(_host_task(m, f"t{k}", lambda chunk: None,
                                    deps=[tasks[-1]]))
        horizon = ig.Instruction(ig.InstructionType.HORIZON, node=0,
                                 queue=("host",), name="H")
        horizon.add_dependency(tasks[-1], m["task_graph"].DepKind.SYNC)
        fin, cmd = _epoch(m)
        fin.add_dependency(horizon, m["task_graph"].DepKind.SYNC)
        ex.submit(tasks + [horizon, fin])
        ex.wait_epoch(cmd.cid, timeout=30)
        return (len(ex._registered), ex._retired_count,
                tasks[0].dependents, tasks[5].dependencies)
    finally:
        ex.shutdown()


def test_horizon_completion_retires_instructions():
    """Completed instructions are dropped from _registered at horizons; the
    counts equal the JAX package's executor's on the same program."""
    got = _horizon_program(port_core)
    retained, retired, dependents, dependencies = got
    assert retained <= 1
    assert retired >= 20
    assert dependents == [] and dependencies == []
    assert got[:2] == _horizon_program(ref_core)[:2]


def _peak_run(api, steps: int):
    with _runtime(api, num_nodes=1, devices_per_node=2) as rt:
        B = rt.buffer((64,), init=np.zeros(64), name="b")
        for i in range(steps):
            rt.submit(f"k{i}", (64,), [api.read_write(B, api.one_to_one())],
                      lambda c, v: None)
        rt.sync(timeout=120)
        ex = rt.executors[0]
        return ex._peak_registered, len(ex._registered), \
            rt.total_instructions()


def test_runtime_peak_registered_bounded():
    """End-to-end: retained instructions do not grow with program length.
    Totals and retained counts equal the JAX package's; both peaks stay
    within the reference's bound."""
    counts = {}
    for api in (port_core, ref_core):
        peak_s, final_s, total_s = _peak_run(api, 60)
        peak_l, final_l, total_l = _peak_run(api, 240)
        assert total_l > 3 * total_s
        assert final_s <= 8 and final_l <= 8
        assert peak_l < total_l / 3
        assert peak_l <= peak_s + 120
        counts[api] = (final_s, total_s, final_l, total_l)
    assert counts[port_core] == counts[ref_core]


@pytest.mark.parametrize("nodes", [1, 2])
def test_results_unchanged_by_redesign(nodes):
    """The ready-queue engine computes the same data as a plain loop."""
    with _runtime(port_core, num_nodes=nodes, devices_per_node=2) as rt:
        B = rt.buffer((32,), init=np.arange(32, dtype=np.float64), name="b")

        def bump(chunk, v):
            v.set(chunk, v.get(chunk) + 1.0)

        for i in range(12):
            rt.submit(f"bump{i}", (32,),
                      [port_core.read_write(B, port_core.one_to_one())], bump)
        out = rt.gather(B)
    np.testing.assert_allclose(out, np.arange(32) + 12.0)
