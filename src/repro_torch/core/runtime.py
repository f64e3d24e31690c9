"""User-facing Celerity-style runtime (paper §2, architecture §4 / fig. 5).

The main thread submits *command groups* and creates task objects (TDAG).
Each simulated cluster node ("rank") runs its own **scheduler thread** —
replicated-deterministic CDAG generation plus per-node IDAG compilation with
lookahead — and its own **executor thread** with backend lanes.  All
inter-thread hand-off is via SPSC queues; pilot messages are posted by the
scheduler as soon as sends are compiled, ahead of execution (§4.2).

A single process hosts all ranks; the protocol — pilots, receive
arbitration, push/await-push asymmetry — is the paper's, byte for byte.  See
DESIGN.md §2 for the deviation record.

Port of ``src/repro/core/runtime.py``: the same API plus ``device=``.  Device
memories live on the CUDA card by default; ``device="cpu"`` keeps every
memory on the host (the tests' mode).  A CUDA request without a card raises.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .allocation import device_memory
from .buffer import Accessor, VirtualBuffer
from .command_graph import CommandGraphGenerator, CommandType
from .communicator import Communicator
from .executor import Executor
from .faults import ExecutionAborted, FaultPlan, run_with_restarts
from .instruction_graph import IdagGenerator, InstructionType
from .lookahead import LookaheadScheduler
from .observability import (CriticalPathReport, MetricsRegistry,
                            critical_path, lane_utilization)
from .region import Box
from .task_graph import Task, TaskGraph, TaskType
from .tracing import Tracer
from .verify import ScheduleVerifier


@dataclass
class _EpochRequest:
    task: Task
    futures: list["queue.SimpleQueue"]


class _NodeScheduler:
    """Scheduler thread of one rank: TDAG stream -> CDAG -> lookahead -> IDAG."""

    def __init__(self, node: int, rt: "Runtime"):
        self.node = node
        self.rt = rt
        self.cdag = CommandGraphGenerator(rt.num_nodes, retire_for=node,
                                          collectives=rt.collectives,
                                          allreduce=rt.reduction_allreduce)
        budgets: dict[int, int] = dict(rt.memory_budgets or {})
        if rt.device_memory_budget is not None:
            for d in range(rt.devices_per_node):
                budgets.setdefault(device_memory(d), rt.device_memory_budget)
        self.idag = IdagGenerator(node, rt.devices_per_node, d2d=rt.d2d,
                                  retire=True, budgets=budgets or None,
                                  metrics=rt.metrics_registry,
                                  renaming=rt.renaming)
        self.lookahead = LookaheadScheduler(self.idag, enabled=rt.lookahead,
                                            retire_compiled=True,
                                            metrics=rt.metrics_registry,
                                            tracer=rt.tracer)
        self.inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        # bootstrap instructions (initial epoch) emitted at construction;
        # count its sync instruction so the throttle lag is not off by one
        bootstrap = list(self.idag.instructions)
        self._horizons_sent = sum(
            1 for i in bootstrap
            if i.itype in (InstructionType.HORIZON, InstructionType.EPOCH))
        if rt.verifier is not None:
            rt.verifier.capture(node, bootstrap)
        rt.executors[node].submit(bootstrap)
        self._thread = threading.Thread(target=self._run,
                                        name=f"sched-N{node}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        rt = self.rt
        while True:
            msg = self.inbox.get()
            if msg is None:
                return
            tr = rt.tracer
            t0 = tr.now() if tr else 0.0
            if isinstance(msg, _EpochRequest):
                task = msg.task
            else:
                task = msg
            cmds = self.cdag.process(task)
            t1 = tr.now() if tr else 0.0
            my_epoch_cid: Optional[int] = None
            instrs = []
            for cmd in cmds:
                if cmd.node != self.node:
                    continue
                if cmd.ctype == CommandType.EPOCH:
                    my_epoch_cid = cmd.cid
                instrs.extend(self.lookahead.push(cmd))
            # pilots are transmitted as soon as the sends are compiled (§3.4)
            self._post_new_pilots()
            if instrs:
                # snapshot before submit: the executor rebinds dependency
                # lists when it retires instructions
                span = (rt.verifier.capture(self.node, instrs)
                        if rt.verifier is not None else None)
                rt.executors[self.node].submit(instrs)
                if span is not None and rt.verifier.mode == "window":
                    # async: enqueues the span for the verifier worker
                    # thread, concurrent with the executor draining it
                    rt.verifier.verify_window(self.node, span)
                self._horizons_sent += sum(
                    1 for i in instrs
                    if i.itype in (InstructionType.HORIZON,
                                   InstructionType.EPOCH))
            t2 = tr.now() if tr else 0.0
            waited = bool(instrs) and self._throttle()
            if tr:
                meta = {"tid": task.tid}
                lane = f"sched-N{self.node}"
                tr.span(lane, "sched.cdag", task.name, t0, t1, meta)
                tr.span(lane, "sched.idag", task.name, t1, t2, meta)
                if waited:
                    tr.span(lane, "sched.throttle", task.name, t2, tr.now(),
                            meta)
            self._sample_lag()
            if isinstance(msg, _EpochRequest):
                msg.futures[self.node].put(my_epoch_cid)

    def _sample_lag(self) -> None:
        """Scheduler-lag time series (DESIGN.md §11.4), sampled per task:
        how many horizon windows the scheduler runs ahead of execution."""
        rt = self.rt
        if rt.metrics_registry is None and rt.tracer is None:
            return
        name = f"sched.N{self.node}.horizon_lag"
        lag = float(self._horizons_sent
                    - rt.executors[self.node].horizons_done)
        if rt.metrics_registry is not None:
            rt.metrics_registry.gauge(name, lag)
        if rt.tracer is not None:
            rt.tracer.counter(name, lag)

    def _throttle(self) -> bool:
        """Bound scheduler run-ahead to ``max_horizon_lag`` horizon windows;
        returns whether it waited.

        Without this the scheduler can compile arbitrarily far ahead of
        execution, and completed-instruction retirement (which happens when
        horizons *execute*) never catches up — retained-instruction memory
        would grow linearly with program length on execution-bound runs.
        """
        rt = self.rt
        lag_limit = (rt.max_inflight_windows
                     if rt.max_inflight_windows is not None
                     else rt.max_horizon_lag)
        if not lag_limit:
            return False
        ex = self.rt.executors[self.node]
        waited = False
        while (self._horizons_sent - ex.horizons_done) > lag_limit:
            if ex.errors or self.rt._shut:
                return waited
            ex.horizon_event.clear()
            if (self._horizons_sent - ex.horizons_done) <= lag_limit:
                return waited
            ex.horizon_event.wait(0.01)
            waited = True
        return waited

    _pilot_cursor = 0

    def _post_new_pilots(self) -> None:
        pilots = self.idag.pilots
        new = pilots[self._pilot_cursor:]
        for p in new:
            self.rt.comm.post_pilot(p)
        self._pilot_cursor += len(new)
        if new and self.rt.verifier is not None:
            self.rt.verifier.capture_pilots(new)
        # posted pilots are never re-read: trim so the list stays bounded
        # (only this scheduler thread touches idag.pilots)
        if self._pilot_cursor:
            del pilots[:self._pilot_cursor]
            self._pilot_cursor = 0

    def shutdown(self) -> None:
        self.inbox.put(None)
        self._thread.join(timeout=10)


def make_tracer(trace, **kw) -> Optional[Tracer]:
    """The tracer of ``trace=``: ``False`` none; ``True`` (or its second
    spelling ``"spans"``) one that also records garbage collections until
    the runtime's shutdown closes it."""
    if trace not in (False, True, "spans"):
        raise ValueError(
            f"trace must be False, True or 'spans', got {trace!r}")
    if not trace:
        return None
    tracer = Tracer(**kw)
    tracer.watch_gc()
    return tracer


def resolve_device(device) -> torch.device:
    """``"cuda"`` or ``"cpu"``; a CUDA request without a card raises instead
    of running on the host.  Simulated devices spread over all cards."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu") or dev.index is not None:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    return dev


class Runtime:
    """The distributed queue a user program submits command groups to."""

    def __init__(self, num_nodes: int = 1, devices_per_node: int = 1, *,
                 device="cuda",
                 lookahead: bool = True, d2d: bool = True,
                 check_bounds: bool = False, trace: bool | str = False,
                 horizon_step: int = 4, queues_per_device: int = 2,
                 host_threads: int = 4, max_horizon_lag: int = 8,
                 device_memory_budget: Optional[int] = None,
                 memory_budgets: Optional[dict[int, int]] = None,
                 collectives: bool = True, reduction_fusion: bool = True,
                 reduction_allreduce: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 reliable: bool = True,
                 watchdog_timeout: Optional[float] = None,
                 retransmit_timeout: float = 0.05, max_retries: int = 12,
                 metrics: bool = True, renaming: bool = False,
                 issue_width: Optional[int] = None,
                 max_inflight_windows: Optional[int] = None,
                 verify: str = "off"):
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.devices_per_node = devices_per_node
        self.lookahead = lookahead
        self.max_horizon_lag = max_horizon_lag
        # out-of-order issue (DESIGN.md §13): allocation renaming eliminates
        # WAR/WAW hazards at lowering time; ``max_inflight_windows`` is the
        # reorder-buffer-style bound on horizon windows between lowering and
        # retirement (when given it replaces ``max_horizon_lag``); and
        # ``issue_width`` caps instructions issued per executor drain pass
        self.renaming = renaming
        self.issue_width = issue_width
        self.max_inflight_windows = max_inflight_windows
        # collective exchange layer (DESIGN.md §9): tree/recursive-doubling
        # collectives instead of N*(N-1) point-to-point pushes, and packed
        # fusion of adjacent reduction exchanges
        self.collectives = collectives
        self.reduction_fusion = reduction_fusion and collectives
        # reduce-scatter + allgather allreduce for order-free reduction
        # exchanges (DESIGN.md §9): ~2/N of the full-partial bytes.
        # ``False`` retains the slot-allgather exchange everywhere — the
        # fallback/oracle path the allreduce must match bit for bit.
        self.reduction_allreduce = reduction_allreduce and collectives
        # per-device-memory byte budget (None = unbudgeted, the historical
        # behavior); ``memory_budgets`` maps explicit memory ids -> bytes
        # for finer control (e.g. a pinned-host budget), overriding the
        # per-device default where both are given
        self.device_memory_budget = device_memory_budget
        self.memory_budgets = memory_budgets
        self.d2d = d2d
        self.tracer = make_tracer(trace)
        # unified metrics registry (DESIGN.md §11): one namespace for
        # executor wait-state histograms, scheduler-lag gauges, memory
        # pressure and transport counters — snapshot via ``metrics()``
        self.metrics_registry = MetricsRegistry() if metrics else None
        self.tdag = TaskGraph(horizon_step=horizon_step,
                              fuse_reductions=self.reduction_fusion)
        # fault model + resilient transport (DESIGN.md §10): the communicator
        # injects wire faults and runs the ack/retransmit protocol; executors
        # inject crash/slow faults and run the watchdog
        self.fault_plan = fault_plan
        self.comm = Communicator(num_nodes, reliable=reliable,
                                 fault_plan=fault_plan,
                                 retransmit_timeout=retransmit_timeout,
                                 max_retries=max_retries,
                                 tracer=self.tracer,
                                 metrics=self.metrics_registry)
        # schedule sanitizer (DESIGN.md §14): "final" verifies the captured
        # instruction streams at every sync; "window" additionally checks
        # each submitted window on the scheduler thread, concurrent with
        # its execution
        if verify not in ("off", "final", "window"):
            raise ValueError(
                f"verify must be 'off', 'final' or 'window', got {verify!r}")
        self.verifier: Optional[ScheduleVerifier] = None
        if verify != "off":
            vbudgets: dict[int, int] = dict(memory_budgets or {})
            if device_memory_budget is not None:
                for d in range(devices_per_node):
                    vbudgets.setdefault(device_memory(d), device_memory_budget)
            self.verifier = ScheduleVerifier(num_nodes, mode=verify,
                                             metrics=self.metrics_registry,
                                             budgets=vbudgets or None)
        self.executors = [Executor(n, devices_per_node, self.comm,
                                   device=self.device,
                                   queues_per_device=queues_per_device,
                                   host_threads=host_threads,
                                   check_bounds=check_bounds,
                                   tracer=self.tracer,
                                   metrics=self.metrics_registry,
                                   fault_plan=fault_plan,
                                   watchdog_timeout=watchdog_timeout,
                                   issue_width=issue_width)
                          for n in range(num_nodes)]
        self.schedulers = [_NodeScheduler(n, self) for n in range(num_nodes)]
        self._shut = False

    # -- user API ------------------------------------------------------------
    def buffer(self, shape: Sequence[int], dtype=np.float64, *,
               name: str = "", init: Optional[np.ndarray] = None) -> VirtualBuffer:
        return VirtualBuffer(shape=tuple(shape), dtype=np.dtype(dtype),
                             name=name, initial_value=init)

    def submit(self, name: str, index_space, accessors: Sequence[Accessor],
               kernel_fn: Callable | None = None, *,
               ttype: TaskType = TaskType.KERNEL,
               split_dims: Sequence[int] = (0,),
               granularity: Sequence[int] = (1,)) -> Task:
        t0 = self.tracer.now() if self.tracer else 0.0
        task = self.tdag.submit(name, index_space, accessors, kernel_fn,
                                ttype=ttype, split_dims=split_dims,
                                granularity=granularity)
        if self.tracer:
            self.tracer.span("main", "task", name, t0, self.tracer.now(),
                             {"tid": task.tid})
        # the TDAG may have auto-emitted a horizon right after this task
        self._broadcast()
        return task

    _sent = 0

    def _broadcast(self) -> None:
        # ``_sent`` counts lifetime task indices; the TDAG list may have a
        # retired prefix (``_base``), so index relative to it
        newly = self.tdag.tasks[self._sent - self.tdag._base:]
        for task in newly:
            if task.ttype == TaskType.EPOCH and task.name == "init":
                self._sent += 1
                continue
            for sched in self.schedulers:
                sched.inbox.put(task)
            self._sent += 1
        # everything broadcast and behind the last sync point can retire
        self.tdag.retire_to(self._sent)

    def sync(self, timeout: float = 120.0) -> None:
        """Emit an epoch and block until every rank has executed it."""
        epoch = self.tdag.emit_epoch("sync")
        futures = [queue.SimpleQueue() for _ in range(self.num_nodes)]
        # flush any tasks emitted before the epoch, then the epoch itself
        newly = self.tdag.tasks[self._sent - self.tdag._base:]
        for task in newly:
            if task is epoch:
                req = _EpochRequest(task=epoch, futures=futures)
                for sched in self.schedulers:
                    sched.inbox.put(req)
            else:
                for sched in self.schedulers:
                    sched.inbox.put(task)
            self._sent += 1
        self.tdag.retire_to(self._sent)
        failures: list[tuple[int, BaseException]] = []
        for n, ex in enumerate(self.executors):
            cid = futures[n].get(timeout=timeout)
            if cid is None:
                continue
            try:
                ex.wait_epoch(cid, timeout=timeout)
            except Exception as e:  # noqa: BLE001 — aggregated below
                failures.append((n, ex.errors[0] if ex.errors else e))
        # a node whose epoch landed before a late-arriving abort still holds
        # an error — fold those in so the report names every failed rank
        for n, ex in enumerate(self.executors):
            if ex.errors and all(fn != n for fn, _ in failures):
                failures.append((n, ex.errors[0]))
        if failures:
            raise ExecutionAborted(
                "executor failure; " + self.comm.transport_summary(),
                sorted(failures)) from failures[0][1]
        if self.verifier is not None:
            self.verifier.finalize(
                peaks=[dict(s.idag.mem.peak) for s in self.schedulers])
            self.verifier.check()

    def gather(self, buf: VirtualBuffer, timeout: float = 120.0) -> np.ndarray:
        """Assemble the current buffer contents on the caller's side, as
        numpy (the gather task reads host tensors)."""
        from .buffer import read as read_acc
        from .range_mapper import one_to_one
        out = np.empty(buf.shape, dtype=buf.dtype)
        lock = threading.Lock()

        def collect(chunk: Box, view) -> None:
            data = view.get(chunk).numpy()
            sl = tuple(slice(a, b) for a, b in zip(chunk.min, chunk.max))
            with lock:
                out[sl] = data

        self.submit(f"gather {buf.name}", buf.shape,
                    [read_acc(buf, one_to_one())], collect,
                    ttype=TaskType.HOST)
        self.sync(timeout=timeout)
        return out

    # -- diagnostics -----------------------------------------------------------
    @property
    def warnings(self) -> list[str]:
        w = list(self.tdag.warnings)
        for s in self.schedulers:
            w.extend(s.cdag.errors)
            w.extend(s.idag.warnings)
        for ex in self.executors:
            w.extend(ex.warnings)
        return w

    def comm_stats(self) -> dict:
        """Wire-level accounting: total messages/bytes plus the collective-
        round share (DESIGN.md §9) and the resilient-transport counters
        (DESIGN.md §10).  Retransmit traffic is accounted separately
        (``retries``/``retry_bytes``) so logical message/byte counts stay
        fault-independent."""
        return dict(messages=self.comm.num_messages,
                    bytes=self.comm.bytes_sent,
                    coll_messages=self.comm.coll_messages,
                    coll_bytes=self.comm.coll_bytes,
                    red_messages=self.comm.red_messages,
                    red_bytes=self.comm.red_bytes,
                    retries=self.comm.retries,
                    retry_bytes=self.comm.retry_bytes,
                    acks=self.comm.acks,
                    aborts=self.comm.aborts,
                    dups_suppressed=sum(ex.arbiter.dups_suppressed
                                        for ex in self.executors),
                    stale_rejected=sum(ex.arbiter.stale_rejected
                                       for ex in self.executors),
                    faults_injected=dict(self.comm.fault_counts))

    def metrics(self) -> dict:
        """One unified observability snapshot (DESIGN.md §11).

        Merges the metrics registry (counters / gauges / histograms with
        p50/p95/p99) with the previously scattered stat dicts: wire-level
        ``comm`` accounting, the per-node ``memory`` reports, per-node
        ``lookahead`` and ``executor`` scheduler stats, and the traced
        instant-event histogram when tracing is on.
        """
        from dataclasses import asdict
        snap = (self.metrics_registry.snapshot()
                if self.metrics_registry is not None
                else dict(counters={}, gauges={}, histograms={}))
        snap["comm"] = self.comm_stats()
        snap["memory"] = self.memory_report()
        snap["lookahead"] = {n: asdict(s.lookahead.stats)
                             for n, s in enumerate(self.schedulers)}
        snap["executor"] = {
            n: dict(done=ex._done_count, retired=ex._retired_count,
                    peak_registered=ex._peak_registered,
                    horizons_done=ex.horizons_done,
                    queue_latency_ewma=ex.straggler_report())
            for n, ex in enumerate(self.executors)}
        if self.tracer is not None:
            snap["instants"] = self.tracer.instant_counts()
        return snap

    def critical_path_report(self) -> CriticalPathReport:
        """Critical-path / wait-state attribution over the traced run.

        Requires ``trace=True``; call after a ``sync()`` so the chain ends
        at a quiesced epoch.
        """
        if self.tracer is None:
            raise RuntimeError(
                "critical_path_report() needs Runtime(trace=True)")
        return critical_path(self.tracer)

    def utilization_report(self) -> dict:
        """Per-device-lane busy/idle occupancy over the traced run.

        Computed from the flight recorder's :class:`InstrRecord` stamps
        (union of execution intervals per backend lane over the global
        observation window); the ``occupancy`` key is the mean busy
        fraction over all lanes — the number the renaming/issue-window
        knobs (DESIGN.md §13) are meant to push up.  Requires
        ``Runtime(trace=True)``.
        """
        if self.tracer is None:
            raise RuntimeError(
                "utilization_report() needs Runtime(trace=True)")
        with self.tracer._lock:
            records = list(self.tracer.records)
        return lane_utilization(records)

    def thread_report(self) -> dict:
        """Worker-thread health after shutdown: leaked (unjoinable) thread
        count per node plus the warning text explaining each leak."""
        return dict(
            leaked_threads={n: ex.leaked_threads
                            for n, ex in enumerate(self.executors)},
            total_leaked=sum(ex.leaked_threads for ex in self.executors),
            warnings=[w for ex in self.executors for w in ex.warnings])

    def total_instructions(self) -> int:
        return sum(s.idag.emitted_count for s in self.schedulers)

    def total_allocs(self) -> int:
        return sum(s.idag.alloc_count for s in self.schedulers)

    def device_peak_bytes(self) -> int:
        """Max real materialized bytes observed in any device memory of any
        node — the high-water mark budget acceptance compares against."""
        from .allocation import is_device_memory
        return max((v for ex in self.executors
                    for mid, v in ex.mem_peak.items() if is_device_memory(mid)),
                   default=0)

    def memory_report(self) -> list[dict]:
        """Per-node memory-layer report: the scheduler-side compile-time
        model (budgets, modeled peaks, spill/reload/eviction counters) and
        the executor-side real materialized-byte peaks per memory id.

        With a card, ``cuda_allocated`` and ``cuda_max_allocated`` add
        PyTorch's own counts (``torch.cuda.memory_allocated`` and
        ``max_memory_allocated``, summed over the cards) beside
        ``real_peak``.  They are process-wide (every node and simulated
        device shares the cards, and the kernels' temporaries count too),
        so a budget is held by ``real_peak`` alone."""
        cuda = None
        if self.device.type == "cuda":
            cards = range(torch.cuda.device_count())
            cuda = (sum(torch.cuda.memory_allocated(c) for c in cards),
                    sum(torch.cuda.max_memory_allocated(c) for c in cards))
        out = []
        for n in range(self.num_nodes):
            mm = self.schedulers[n].idag.mem
            ex = self.executors[n]
            rep = mm.snapshot()
            rep["node"] = n
            rep["real_used"] = dict(ex.mem_used)
            rep["real_peak"] = dict(ex.mem_peak)
            rep["cuda_allocated"], rep["cuda_max_allocated"] = \
                cuda if cuda is not None else (None, None)
            rep["leaked_threads"] = ex.leaked_threads
            out.append(rep)
        return out

    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        # a failed/crashed grid cannot reach another epoch: skip the final
        # sync (it would burn the full timeout) and go straight to teardown
        if not any(ex.errors or ex.crashed for ex in self.executors):
            try:
                self.sync()
            except Exception:
                pass
        for s in self.schedulers:
            s.shutdown()
        for ex in self.executors:
            ex.shutdown()
        self.comm.drop_in_flight()
        if self.tracer is not None:
            self.tracer.close()
        # final registry values become Perfetto counter samples, so the
        # exported trace carries the unified metrics end state
        if self.tracer is not None and self.metrics_registry is not None:
            self.metrics_registry.export_counters(self.tracer)

    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- supervised execution (DESIGN.md §10.4) ------------------------------
    @classmethod
    def run_supervised(cls, build, step, *, steps: int, num_nodes: int,
                       devices_per_node: int = 1, checkpoint_every: int = 1,
                       max_restarts: int = 3, min_nodes: int = 1,
                       fault_plan: Optional[FaultPlan] = None,
                       manager=None, watchdog_timeout: Optional[float] = 2.0,
                       sync_timeout: float = 60.0,
                       **rt_kwargs) -> "SupervisedResult":
        """Run a stepwise program under bounded-restart supervision.

        ``build(rt, init)`` creates the program's buffers on runtime ``rt``
        and returns ``{name: VirtualBuffer}``; ``init`` is ``None`` on a
        fresh start, else the ``{name: ndarray}`` snapshot to resume from.
        ``step(rt, bufs, i)`` submits step ``i``'s command groups.

        Every ``checkpoint_every`` steps the buffers are gathered into an
        in-memory snapshot (and handed to ``manager.save`` when a
        checkpoint manager is supplied).  On a recoverable failure —
        crashed rank, exhausted retransmits, watchdog abort — the grid is
        torn down, any in-flight async checkpoint save is joined
        (``manager.close``), one node is dropped (elastic shrink, floor
        ``min_nodes``), one-shot crash faults are cleared
        (:meth:`FaultPlan.survivors`), and the program is resubmitted from
        the last snapshot.  After ``max_restarts`` failed recoveries the
        last error propagates.
        """
        state: dict = {"step": 0, "snap": None, "world": num_nodes}

        def attempt(restarts: int) -> dict[str, np.ndarray]:
            world = max(min_nodes, num_nodes - restarts)
            plan = (fault_plan.survivors()
                    if (fault_plan is not None and restarts) else fault_plan)
            rt = cls(world, devices_per_node, fault_plan=plan,
                     watchdog_timeout=watchdog_timeout, **rt_kwargs)
            state["world"] = world
            try:
                bufs = build(rt, state["snap"])
                for i in range(state["step"], steps):
                    step(rt, bufs, i)
                    if (i + 1) % checkpoint_every == 0 or i + 1 == steps:
                        snap = {k: rt.gather(b, timeout=sync_timeout)
                                for k, b in sorted(bufs.items())}
                        state["snap"], state["step"] = snap, i + 1
                        if manager is not None:
                            manager.save(i + 1, snap)
                return state["snap"]
            finally:
                rt.shutdown()

        def on_failure(err: BaseException, restarts: int) -> None:
            # join any in-flight async checkpoint save before the next grid
            # comes up — a half-written checkpoint must never race a restore
            if manager is not None:
                manager.close()

        results, restarts = run_with_restarts(attempt, on_failure,
                                              max_restarts=max_restarts)
        if manager is not None:
            manager.close()
        return SupervisedResult(results=results, restarts=restarts,
                                world=state["world"], steps=state["step"])


@dataclass
class SupervisedResult:
    """Outcome of :meth:`Runtime.run_supervised`."""
    results: dict[str, np.ndarray]
    restarts: int
    world: int          # surviving grid size that produced the result
    steps: int          # steps completed (== requested steps on success)
