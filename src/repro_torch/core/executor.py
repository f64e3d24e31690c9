"""Executor: out-of-order instruction dispatch (paper §4.1).

The *out-of-order engine* receives the topologically-ordered instruction
stream from the scheduler together with completion events from the backend,
and selects the next instruction to issue:

* **direct** issue — all dependencies have completed;
* **eager** issue — all *incomplete* dependencies are already pending on the
  same single in-order backend queue; the queue's FIFO semantics then
  guarantee ordering without waiting for completion events.

Receive-type instructions are handed to the per-node ``ReceiveArbiter``
(§4.2) instead of a backend lane; the executor polls the arbiter in its main
loop.  The executor itself does no data processing — it only routes.

Port of ``src/repro/core/executor.py``: the store holds torch tensors, memory
``M2+d`` lives on ``cuda:{d % device_count}`` (every simulated device keeps its
own memory id and streams, even when they share one card), ``M1`` is pinned
host memory and ``M0`` plain host memory.

Reductions keep the reference's value semantics (``reduction.py`` is a
copy): every reduction accumulator scratch is a host numpy array in the
store, whatever memory id the instruction graph gives it.  Exact-sum
accumulators are ``object`` arrays of Python ints, which no card can hold;
keeping the ``max``/``min``/``prod``/custom scratches on the host too keeps
one code path.  A kernel's contribution is brought to the host by its
:class:`ReductionView` on the lane's stream, after the kernel's own work,
and ``LOCAL_REDUCE`` folds host partials, as the reference models it (a
fused device-to-host copy plus a combine).  Byte accounting counts a
scratch as ``ndarray.nbytes``, as the reference does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .allocation import PINNED_HOST, Allocation, is_device_memory
from .backend import Backend, InOrderQueue, WorkItem
from .buffer import AccessMode
from .communicator import (Communicator, Payload, ReceiveArbiter,
                           nbytes_of)
from .faults import (EpochTimeoutError, FaultPlan, InjectedCrash, NodeFailure,
                     PeerAborted)
from .instruction_graph import (AccessorBinding, EpochAbort, Instruction,
                                InstructionType)
from .observability import WAIT_CLASSES, WAIT_DEP, WAIT_OF, WAIT_QUEUE
from .region import Box, Region

# instructions that complete only when a peer's message lands (the arbiter
# completes them); they take no admission slot of their tenant
_PEER_WAIT = frozenset((
    InstructionType.RECEIVE, InstructionType.SPLIT_RECEIVE,
    InstructionType.AWAIT_RECEIVE, InstructionType.GATHER_RECEIVE,
    InstructionType.COLL_RECV))


class BoundsError(RuntimeError):
    """Raised after a kernel when accesses fell outside the declared region."""


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (``Allocation.dtype``)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def host_array(values) -> np.ndarray:
    """``values`` as a host numpy array for the reduction value semantics.

    A tensor on a card is copied to the host on the current stream, which
    waits for the work queued before it (a kernel's contribution on its
    lane's stream).  Integer dtypes stay integers, so exact sums of int64
    stay exact; bfloat16 and float16 widen to float32, which is exact."""
    if not isinstance(values, torch.Tensor):
        return np.asarray(values)
    t = values.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class BufferView:
    """Kernel-facing accessor backed by one contiguous allocation (§3.2).

    Indexing is in *global buffer coordinates*; the view translates to the
    allocation's local frame.  With ``check_bounds`` the view records any
    access outside the range-mapper-declared region and the executor raises
    a :class:`BoundsError` with the offending bounding box after the kernel
    exits (paper §4.4 "Accessor Bounds Checking").
    """

    __slots__ = ("array", "offset", "region", "writable", "check_bounds",
                 "oob_min", "oob_max")

    def __init__(self, array: torch.Tensor, alloc: Allocation,
                 binding: AccessorBinding, check_bounds: bool):
        self.array = array
        self.offset = alloc.box.min
        self.region = binding.region
        self.writable = binding.accessor.mode.is_producer
        self.check_bounds = check_bounds
        self.oob_min: Optional[list[int]] = None
        self.oob_max: Optional[list[int]] = None

    # -- box-level access (the fast path used by example kernels) ----------
    def get(self, box: Box) -> torch.Tensor:
        self._check(box)
        sl = tuple(slice(a - o, b - o) for a, b, o in
                   zip(box.min, box.max, self.offset))
        return self.array[sl]

    def set(self, box: Box, values) -> None:
        if not self.writable:
            raise PermissionError("write through read-only accessor")
        self._check(box)
        sl = tuple(slice(a - o, b - o) for a, b, o in
                   zip(box.min, box.max, self.offset))
        self.array[sl] = self._tensor(values)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=self.array.dtype,
                               device=self.array.device)

    def _check(self, box: Box) -> None:
        if not self.check_bounds:
            return
        if not self.region.contains_box(box):
            if self.oob_min is None:
                self.oob_min, self.oob_max = list(box.min), list(box.max)
            else:
                self.oob_min = [min(a, b) for a, b in zip(self.oob_min, box.min)]
                self.oob_max = [max(a, b) for a, b in zip(self.oob_max, box.max)]

    # -- element access sugar ----------------------------------------------
    def __getitem__(self, idx):
        box = self._idx_box(idx)
        return self.get(box).reshape(self._idx_shape(idx, box))

    def __setitem__(self, idx, values):
        box = self._idx_box(idx)
        self.set(box, self._tensor(values).reshape(box.shape))

    def _idx_box(self, idx) -> Box:
        if not isinstance(idx, tuple):
            idx = (idx,)
        lo, hi = [], []
        for d, i in enumerate(idx):
            if isinstance(i, slice):
                start = 0 if i.start is None else i.start
                stop = (self.offset[d] + self.array.shape[d]) if i.stop is None else i.stop
                lo.append(start)
                hi.append(stop)
            else:
                lo.append(int(i))
                hi.append(int(i) + 1)
        return Box(tuple(lo), tuple(hi))

    @staticmethod
    def _idx_shape(idx, box: Box):
        if not isinstance(idx, tuple):
            idx = (idx,)
        shape = []
        for d, i in enumerate(idx):
            if isinstance(i, slice):
                shape.append(box.shape[d])
        return tuple(shape) if shape else ()


class ReductionView:
    """Kernel-facing reduction output (paper §2.2).

    Wraps the identity-filled accumulator scratch of one device chunk (a
    host numpy array); the kernel calls :meth:`contribute` with per-item
    contribution values (for a scalar reduction: any array of
    contributions), as a tensor on its device or an array.  The runtime owns
    the partial/exchange/combine pipeline — the kernel never sees peer data.
    """

    __slots__ = ("acc", "op")

    def __init__(self, acc: np.ndarray, op):
        self.acc = acc
        self.op = op

    def contribute(self, values) -> None:
        self.op.contribute(self.acc, host_array(values))


class Executor:
    """Per-node executor thread harboring the out-of-order engine.

    The engine is a *dependency-counter ready queue*: an instruction moves to
    the ready deque exactly when its unmet-dependency counter hits zero, and
    eager-issue candidates are re-examined only when one of their
    dependencies is issued on a device queue or completes — there is no
    per-iteration rescan of a waiting list.  All wake-up sources (backend
    completions, scheduler submissions, inbound communicator traffic) set the
    completion-sink event, so the main loop blocks instead of polling.
    Completed instructions are retired when a later horizon/epoch completes,
    bounding tracking-structure memory on long runs (§3.5).
    """

    def __init__(self, node: int, num_devices: int, comm: Communicator,
                 *, device: torch.device,
                 queues_per_device: int = 2, host_threads: int = 4,
                 check_bounds: bool = False, tracer=None, metrics=None,
                 fault_plan: Optional[FaultPlan] = None,
                 watchdog_timeout: Optional[float] = None,
                 max_inflight_per_tenant: Optional[int] = None,
                 issue_width: Optional[int] = None):
        self.node = node
        # issue-width knob (DESIGN.md §13): cap untagged direct/eager issues
        # per drain pass so one burst cannot monopolize the loop before the
        # next completion/ingest poll; None = unbounded (historical)
        self.issue_width = issue_width
        self.comm = comm
        # where each memory id lives: device memories on the CUDA device
        # (simulated devices share the cards round-robin), host memories on
        # the CPU, pinned when a card is in use
        self.device = device
        self._cuda = device.type == "cuda"
        self._ncards = torch.cuda.device_count() if self._cuda else 1
        # with a tracer the lanes stamp each item's launch and sync, and
        # completed epochs keep their time
        self._stamped = tracer is not None
        self.backend = Backend(num_devices, device_of=self.device_of,
                               queues_per_device=queues_per_device,
                               host_threads=host_threads,
                               stamped=self._stamped)
        self.store: dict[int, torch.Tensor] = {}     # allocation id -> tensor
        self.arbiter = ReceiveArbiter(node, comm, self.store)
        self.check_bounds = check_bounds
        self.tracer = tracer
        # observability (DESIGN.md §11): wait-state attribution + issue-path
        # histograms.  ``_obs`` gates every added stamp/record so that a
        # bare executor (tracer=None, metrics=None) pays nothing.
        self.metrics = metrics
        self._obs = tracer is not None or metrics is not None
        # duck-typed tracer doubles get per-instruction issue() callbacks;
        # the standard Tracer opts out via ``issue_events = False`` (one
        # less lock round-trip on the issue hot path)
        self._issue_tracer = tracer if (
            tracer is not None and getattr(tracer, "issue_events", True)) \
            else None
        # sampled (1-in-N) record capture: the keep/drop decision is a pure
        # function of the iid, so dropped records skip the tracer call
        # entirely — drops are counted locally (this executor's completion
        # path is single-threaded) and flushed at horizon boundaries
        self._rec_sample = (max(1, getattr(tracer, "record_sample", 1))
                            if tracer is not None else 1)
        self._drops_pending = 0
        if metrics is not None:
            p = f"executor.N{node}."
            self._h_issue = metrics.histogram(p + "issue_us")
            self._h_queue = metrics.histogram(p + "wait_queue_us")
            self._h_wait = {c: metrics.histogram(p + f"wait_{c}_us")
                            for c in WAIT_CLASSES if c != WAIT_QUEUE}
        else:
            self._h_issue = self._h_queue = None
            self._h_wait = {}
        self.errors: list[BaseException] = []
        # real materialized bytes per memory id, accounted at ALLOC/FREE
        # execution time (the compile-time model lives in the scheduler's
        # MemoryManager; this is the ground truth the budget must bound).
        # M0 is user-owned and lazily seeded — it has no ALLOC instructions
        # and is deliberately not tracked here.
        self.mem_used: dict[int, int] = {}
        self.mem_peak: dict[int, int] = {}
        self._mem_lock = threading.Lock()

        self._inbox: deque[Instruction] = deque()
        self._inbox_lock = threading.Lock()
        self._registered: dict[int, Instruction] = {}
        self._remaining: dict[int, int] = {}          # iid -> unmet dep count
        self._ready: deque[Instruction] = deque()     # counter hit zero
        self._blocked: dict[int, Instruction] = {}    # unmet deps remain
        self._recheck: deque[Instruction] = deque()   # eager-issue candidates
        self._retire_log: deque[Instruction] = deque()  # registration order
        self._peak_registered = 0
        self._retired_count = 0
        self._issued_on: dict[int, InOrderQueue] = {} # iid -> queue (devices)
        self._completed_epochs: set[int] = set()      # command ids of epochs
        self._epoch_done_t: dict[int, float] = {}     # with a tracer
        self.horizons_done = 0                        # completed sync instrs
        self.horizon_event = threading.Event()        # set on each completion
        self._epoch_cv = threading.Condition()
        self._done_count = 0
        # -- multi-tenant serving (core/memo.py, DESIGN.md §12) -----------
        # Instructions tagged with a tenant name are issued from per-tenant
        # ready queues in round-robin order (fair-share interleaving), with
        # ``max_inflight_per_tenant`` bounding how many of one tenant's
        # kernels, copies, sends, allocations and host tasks may be between
        # admission and completion (admission control).  Receive-side
        # instructions (``_PEER_WAIT``) pass admission without a slot: one
        # completes only when the peer's send lands, and the peer's send
        # may wait for a slot behind the peer's own receive, so a counted
        # receive on each of two nodes deadlocks both.  Every counted
        # instruction completes without a peer (a send only posts), so the
        # deferred queue always drains.  Untagged instructions (tenant
        # None) keep the original single-queue fast path untouched.  Eager
        # issue bypasses admission (it must follow its in-order queue), so
        # the bound is approximate under eager cascades — acceptable:
        # fairness is a scheduling policy, not a correctness invariant.
        self.max_inflight_per_tenant = max_inflight_per_tenant
        self._tenant_ready: dict[str, deque[Instruction]] = {}
        self._tenant_rr: deque[str] = deque()      # round-robin rotation
        self._tenant_in_rr: set[str] = set()
        self._tenant_count = 0                     # total tenant-ready instrs
        self._tenant_inflight: dict[str, int] = {}
        self._tenant_deferred: dict[str, deque[Instruction]] = {}
        self._deferred_count = 0
        self.tenant_done: dict[str, int] = {}      # per-tenant completions
        # in-flight window tracking (DESIGN.md §13): windows with at least
        # one completed instruction whose closing epoch has not completed;
        # the peak set size is the pipelining depth ``bench_serve`` reports
        self._tenant_windows: dict[str, set[int]] = {}
        self.tenant_window_peak: dict[str, int] = {}
        self._queue_latency_ewma: dict[str, float] = {}
        self._qname_cache: dict[tuple, str] = {}
        self._dispatch = {
            InstructionType.ALLOC: self._exec_alloc,
            InstructionType.FREE: self._exec_free,
            InstructionType.COPY: self._exec_copy,
            InstructionType.SPILL: self._exec_copy,
            InstructionType.RELOAD: self._exec_copy,
            InstructionType.SEND: self._exec_send,
            InstructionType.COLL_SEND: self._exec_coll_send,
            InstructionType.FILL_IDENTITY: self._exec_fill_identity,
            InstructionType.LOCAL_REDUCE: self._exec_local_reduce,
            InstructionType.GLOBAL_REDUCE: self._exec_global_reduce,
            InstructionType.DEVICE_KERNEL: self._exec_kernel,
            InstructionType.HOST_TASK: self._exec_kernel,
        }
        # -- fault model (DESIGN.md §10) ----------------------------------
        self.fault_plan = fault_plan
        self.watchdog_timeout = watchdog_timeout
        self._crash_at = fault_plan.crash_point(node) if fault_plan else None
        self._slow_s = fault_plan.slow_s(node) if fault_plan else 0.0
        self._issued_count = 0
        # instructions handed to a backend lane and not yet completed
        # (issued and drained on the executor thread; the watchdog reads it)
        self._on_lanes = 0
        self.crashed = False
        self.warnings: list[str] = []
        self.leaked_threads = 0
        self._abort = False             # force-exit flag (shutdown fallback)
        self._abort_sent = False        # at most one EPOCH_ABORT broadcast
        self._stop = False
        self._drained = threading.Event()
        comm.add_listener(node, self.backend.sink.event)
        self._thread = threading.Thread(target=self._run, name=f"exec-N{node}",
                                        daemon=True)
        self._thread.start()
        self._watch_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        if watchdog_timeout is not None:
            self._wd_done = -1
            self._wd_mark = time.monotonic()
            self._watchdog = threading.Thread(
                target=self._watch, name=f"watchdog-N{node}", daemon=True)
            self._watchdog.start()

    # -- scheduler-facing API ----------------------------------------------
    def submit(self, instrs: list[Instruction]) -> None:
        with self._inbox_lock:
            self._inbox.extend(instrs)
        self.backend.sink.event.set()  # wake the loop

    def forget_epoch(self, cid: int) -> Optional[float]:
        """Drop a completed epoch id once every waiter has seen it; returns
        the ``perf_counter`` time of its completion where the executor
        traces, else None.

        A serving process completes an unbounded stream of epochs; the
        serving runtime calls this after its window handle resolves so the
        completed-epoch set stays bounded."""
        with self._epoch_cv:
            self._completed_epochs.discard(cid)
            return self._epoch_done_t.pop(cid, None)

    def wait_epoch(self, cid: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        with self._epoch_cv:
            while cid not in self._completed_epochs:
                if self.errors:
                    e = self.errors[0]
                    raise RuntimeError(
                        f"executor N{self.node} failed: "
                        f"{type(e).__name__}: {e}") from e
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise EpochTimeoutError(
                        f"epoch C{cid} not reached on N{self.node}; "
                        + self.stall_report())
                self._epoch_cv.wait(min(rem, 0.05))

    def stall_report(self) -> str:
        """What this executor is stuck on — attached to timeout errors."""
        stuck = next((i for i in self._retire_log if i.state != "done"), None)
        dead = self.comm.stale_peers(self.node, self.watchdog_timeout or 1.0)
        deadtxt = (f"; stale peer heartbeats: {[f'N{p}' for p in dead]}"
                   if dead else "")
        return (f"{len(self._remaining)} instructions unfinished, oldest "
                f"{stuck!r}; arbiter: {self.arbiter.pending_report()}; "
                f"transport: {self.comm.transport_summary()}{deadtxt}")

    def shutdown(self, join_timeout: float = 10.0) -> int:
        """Stop the worker and backend lanes, accounting every thread.

        A failed/crashed executor skips the graceful drain (its blocked work
        would never complete) and takes the abort path directly.  Any thread
        still alive after its join deadline is counted in
        ``leaked_threads`` and recorded as a warning instead of being
        silently ignored.  With every thread joined, the store's tensors
        are released.  Returns the leaked-thread count.
        """
        if self.errors or self.crashed:
            self._abort = True
        if (self._drops_pending and self.tracer is not None
                and hasattr(self.tracer, "note_sampled_out")):
            # account sampled-out records dropped after the last sync
            self.tracer.note_sampled_out(self._drops_pending)
            self._drops_pending = 0
        self._stop = True
        self._watch_stop.set()
        self.backend.sink.event.set()
        self._thread.join(timeout=2.0 if self._abort else join_timeout)
        if self._thread.is_alive():
            # graceful drain did not converge (e.g. poisoned dependencies):
            # abort — the loop discards blocked work at its next wake
            self._abort = True
            self.backend.sink.event.set()
            self._thread.join(timeout=2.0)
        leaked = 0
        if self._thread.is_alive():
            leaked += 1
            self.warnings.append(
                f"executor N{self.node}: worker thread failed to join "
                f"(stuck with {len(self._blocked)} blocked instructions)")
        backend_leaked = self.backend.shutdown(
            join_timeout=1.0 if self._abort else 5.0)
        if backend_leaked:
            leaked += backend_leaked
            self.warnings.append(
                f"executor N{self.node}: {backend_leaked} backend lane "
                f"thread(s) failed to join (kernel still running?)")
        elif not self._thread.is_alive():
            # every lane has finished its stream work (a lane reports an item
            # only after its stream's event), so the tensors an aborted run
            # never freed can go now rather than when the executor is
            # collected; with a lane still running they must stay
            self.store.clear()
            self.arbiter.early_payloads.clear()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
            if self._watchdog.is_alive():
                leaked += 1
                self.warnings.append(
                    f"executor N{self.node}: watchdog thread failed to join")
        self.leaked_threads = leaked
        return leaked

    # -- failure handling (DESIGN.md §10) -------------------------------------
    def _fail(self, err: BaseException, *, broadcast: bool = True,
              dead_peer: Optional[int] = None) -> None:
        """Record a failure, wake epoch waiters NOW, and poison peers."""
        self.errors.append(err)
        with self._epoch_cv:
            self._epoch_cv.notify_all()
        if broadcast and not self._abort_sent and self.comm.num_nodes > 1:
            self._abort_sent = True
            stuck = next((i for i in self._retire_log if i.state != "done"),
                         None)
            self.comm.post_abort(EpochAbort(
                origin=self.node, instruction=repr(stuck) if stuck else "?",
                cause=f"{type(err).__name__}: {err}", dead_peer=dead_peer))

    def _on_abort(self, ab: EpochAbort) -> None:
        """A peer poisoned the epoch: fail fast and drop in-flight receives."""
        if self.tracer is not None and hasattr(self.tracer, "instant"):
            self.tracer.instant(f"N{self.node}.ctrl", "peer_abort",
                                {"origin": ab.origin, "cause": ab.cause})
        self.arbiter.poison(f"abort from N{ab.origin}")
        if not self.errors:
            self._fail(PeerAborted(self.node, ab.origin, ab.dead_peer,
                                   ab.instruction, ab.cause),
                       broadcast=False)

    def _watch(self) -> None:
        """Watchdog: fire when instructions are stuck past the deadline.

        Progress is 'some instruction completed recently'; idle (nothing
        registered, nothing pending) resets the clock, and so does work on
        a backend lane: on a card one copy into a large pinned allocation
        can outlast the deadline, and a node whose lanes are busy is not
        stuck (the reference fires on it).  On fire it names the oldest
        unfinished instruction and the peers whose heartbeats went stale,
        then broadcasts the abort so the whole grid fails within ~1 round
        trip instead of the epoch timeout.
        """
        period = max(0.01, min(self.watchdog_timeout / 4.0, 0.25))
        while not self._watch_stop.wait(period):
            if self._stop or self._abort or self.crashed or self.errors:
                continue
            now = time.monotonic()
            if self._done_count != self._wd_done:
                self._wd_done = self._done_count
                self._wd_mark = now
                continue
            busy = ((bool(self._remaining) or self.arbiter.has_pending())
                    and self._on_lanes <= 0)
            if not busy:
                self._wd_mark = now
                continue
            if now - self._wd_mark < self.watchdog_timeout:
                continue
            stuck = next((i for i in self._retire_log if i.state != "done"),
                         None)
            dead = self.comm.stale_peers(self.node, self.watchdog_timeout, now)
            err = NodeFailure(
                self.node, repr(stuck) if stuck else "?", dead,
                detail=(f"no completions for {now - self._wd_mark:.2f}s; "
                        f"arbiter: {self.arbiter.pending_report()}; "
                        f"transport: {self.comm.transport_summary()}"))
            if self.tracer is not None and hasattr(self.tracer, "instant"):
                self.tracer.instant(f"N{self.node}.ctrl", "watchdog_fire",
                                    {"stuck": err.stuck})
            self._fail(err, dead_peer=dead[0] if dead else None)
            return

    # -- main loop -----------------------------------------------------------
    def _run(self) -> None:
        completions: list[Instruction] = []
        comm, node = self.comm, self.node
        while True:
            if self._abort:
                # forced teardown: blocked/poisoned work is discarded
                self._drained.set()
                return
            comm.beat(node)
            progressed = False
            # 0. transport duty cycle: acks in, retransmits out, and any
            # cross-node abort poison (cheap lock-free gates)
            if comm.reliable and comm.has_transport_work(node):
                for terr in comm.pump(node):
                    self._fail(terr)
            if comm.ctrl_box[node]:
                for ab in comm.poll_ctrl(node):
                    self._on_abort(ab)
            # 1. ingest newly scheduled instructions
            with self._inbox_lock:
                fresh = list(self._inbox)
                self._inbox.clear()
            for instr in fresh:
                self._register(instr)
                progressed = True
            # 2. drain backend completions (unblocks ready/eager candidates)
            for tag, err, lat in self.backend.sink.drain():
                self._on_lanes -= 1
                if err is not None:
                    self._fail(err)
                self._mark_done(tag, lat)
                progressed = True
            # 3. receive arbitration (woken by communicator listener); only
            # touch the mailbox locks when receives are in flight or inbound
            # traffic is visible
            if (self.arbiter.has_pending()
                    or self.comm.payload_box[self.node]
                    or self.comm.pilot_box[self.node]):
                completions.clear()
                self.arbiter.step(completions)
                for instr in completions:
                    self._mark_done(instr, 0.0)
                    progressed = True
            # 4. issue everything that became ready or eager-eligible
            if self._drain_ready():
                progressed = True
            if self.crashed:
                # fail-stop: no drain, no farewell — peers must detect it
                return
            if (self._stop and not self._ready and not self._tenant_count
                    and not self._deferred_count and not self._blocked
                    and not fresh):
                with self._inbox_lock:
                    empty = not self._inbox
                if empty:
                    self._drained.set()
                    return
            if not progressed:
                # every wake source (sink completions, submit, communicator
                # listener) sets this event; drain() clears it pre-swap
                self.backend.sink.event.wait(0.05)

    # -- registration and issue ----------------------------------------------
    def _register(self, instr: Instruction) -> None:
        unmet = 0
        for dep, _ in instr.dependencies:
            if dep.state != "done":
                unmet += 1
        self._registered[instr.iid] = instr
        if len(self._registered) > self._peak_registered:
            self._peak_registered = len(self._registered)
        self._retire_log.append(instr)
        self._remaining[instr.iid] = unmet
        if unmet == 0:
            if self._obs:
                instr._reg_t = instr._ready_t = time.perf_counter()
            if instr.tenant is None:
                self._ready.append(instr)
            else:
                self._enqueue_tenant(instr)
        else:
            if self._obs:
                instr._reg_t = time.perf_counter()
            self._blocked[instr.iid] = instr
            self._recheck.append(instr)     # deps may already sit on one queue

    def _enqueue_tenant(self, instr: Instruction) -> None:
        """Admit (or defer) one ready tenant-tagged instruction."""
        t = instr.tenant
        if instr.itype not in _PEER_WAIT:
            cap = self.max_inflight_per_tenant
            if cap is not None and self._tenant_inflight.get(t, 0) >= cap:
                self._tenant_deferred.setdefault(t, deque()).append(instr)
                self._deferred_count += 1
                return
            self._tenant_inflight[t] = self._tenant_inflight.get(t, 0) + 1
        instr._admitted = True
        q = self._tenant_ready.get(t)
        if q is None:
            q = self._tenant_ready[t] = deque()
        q.append(instr)
        self._tenant_count += 1
        if t not in self._tenant_in_rr:
            self._tenant_in_rr.add(t)
            self._tenant_rr.append(t)

    def _drain_tenant_ready(self) -> bool:
        """Issue tenant-ready instructions one per tenant per rotation."""
        issued_any = False
        rr = self._tenant_rr
        while self._tenant_count and rr:
            name = rr.popleft()
            q = self._tenant_ready.get(name)
            if not q:
                self._tenant_in_rr.discard(name)
                continue
            instr = q.popleft()
            self._tenant_count -= 1
            if q:
                rr.append(name)
            else:
                self._tenant_in_rr.discard(name)
            self._issue(instr)
            issued_any = True
        return issued_any

    def _drain_ready(self) -> bool:
        """Issue all ready instructions and cascade eager-issue candidates.

        With ``issue_width`` set, at most that many untagged direct/eager
        issues happen per pass; the main loop re-enters immediately (the
        pass reports progress) after polling completions and the inbox.
        Tenant-tagged issue is already self-limited by the round-robin
        rotation and admission control, so it is not charged against the
        width."""
        issued_any = False
        left = self.issue_width if self.issue_width is not None else -1
        while self._ready or self._tenant_count or self._recheck:
            if left == 0:
                break
            while self._ready:
                instr = self._ready.popleft()
                self._issue(instr)                       # direct issue
                issued_any = True
                if left > 0:
                    left -= 1
                    if left == 0:
                        break
            if left == 0:
                break
            if self._tenant_count:
                if self._drain_tenant_ready():
                    issued_any = True
            if self._recheck:
                instr = self._recheck.popleft()
                if instr.iid not in self._blocked:
                    continue
                eager_q = self._eager_queue(instr)
                if eager_q is not None:
                    del self._blocked[instr.iid]
                    if self._obs:
                        instr._ready_t = time.perf_counter()
                        # eager issue serializes behind its still-pending
                        # deps on one in-order queue: blame the last one
                        for dep, _ in instr.dependencies:
                            if dep.state != "done":
                                instr._blame_iid = dep.iid
                                instr._blame_it = dep.itype
                    self._issue(instr, queue=eager_q)    # eager issue
                    issued_any = True
                    if left > 0:
                        left -= 1
        return issued_any

    def _eager_queue(self, instr: Instruction) -> Optional[InOrderQueue]:
        """Eager-issue rule (§4.1): all incomplete deps pending on ONE
        in-order queue; instruction itself targets the same device."""
        if instr.queue[0] != "device":
            return None
        q: Optional[InOrderQueue] = None
        for dep, _ in instr.dependencies:
            if dep.state == "done":
                continue
            dq = self._issued_on.get(dep.iid)
            if dq is None:
                return None          # dep not yet submitted anywhere
            if q is None:
                q = dq
            elif q is not dq:
                return None          # spread over several queues
        if q is None:
            return None
        # same device required: queue name "D<d>.q<i>"
        if not q.name.startswith(f"D{instr.queue[1]}."):
            return None
        return q

    # -- issue routing ---------------------------------------------------------
    def _issue(self, instr: Instruction, queue: Optional[InOrderQueue] = None) -> None:
        if self.crashed:
            return                       # fail-stop: issue nothing further
        if self._crash_at is not None:
            self._issued_count += 1
            if self._issued_count >= self._crash_at:
                # injected fail-stop: recorded locally (for the supervisor),
                # never broadcast — a dead rank does not say goodbye
                self.crashed = True
                self._fail(InjectedCrash(
                    f"N{self.node} fail-stopped at issued instruction "
                    f"#{self._issued_count} ({instr!r})"), broadcast=False)
                return
        instr.state = "issued"
        if instr.tenant is not None and not getattr(instr, "_admitted", False):
            # eager issue skipped admission: account it now so the
            # per-tenant in-flight counter stays balanced at completion
            tn = instr.tenant
            self._tenant_inflight[tn] = self._tenant_inflight.get(tn, 0) + 1
            instr._admitted = True
        if self._issue_tracer is not None:
            # issue-time visibility (open span): lets live observers see
            # eager issue before the instruction completes; the standard
            # Tracer opts out (spans derive from completion records)
            self._issue_tracer.issue(self.node, instr)
        it = instr.itype
        if it in _PEER_WAIT:
            if self._obs:               # arbiter-handled: no lane dequeue
                instr._start_t = time.perf_counter()
            self.arbiter.begin(instr)       # completion via arbiter polling
            return
        if it in (InstructionType.HORIZON, InstructionType.EPOCH):
            if self._obs:
                instr._start_t = time.perf_counter()
            self._mark_done(instr, 0.0)     # pure graph-sync: complete inline
            return
        # with observability on, the lane thread stamps the dequeue time so
        # queue-wait (lane contention) separates from execution time
        fn = self._run_timed if self._obs else self._dispatch[it]
        item = WorkItem(fn=fn, tag=instr)
        self._on_lanes += 1
        if instr.queue[0] == "device":
            q = self.backend.pick_device_queue(instr.queue[1], preferred=queue)
            self._issued_on[instr.iid] = q
            q.submit(item)
            # dependents blocked only on instructions now pending on q may
            # eager-issue right away (FIFO ordering makes it safe)
            for dep in instr.dependents:
                if dep.iid in self._blocked:
                    self._recheck.append(dep)
        elif it == InstructionType.SEND:
            # comm lane: sends are tiny (mailbox post) — host pool is fine
            self.backend.host_pool.submit(item)
        else:
            self.backend.host_pool.submit(item)

    def _run_timed(self, instr: Instruction) -> None:
        """Backend-lane entry when observability is on: stamp dequeue time
        (start of execution) so queue-wait separates from execution.  On a
        traced card's lane this is the host's side only: the lane gates the
        item and brackets it with timing events, which ``_obs_done``
        reads."""
        instr._start_t = time.perf_counter()
        self._dispatch[instr.itype](instr)

    def _mark_done(self, instr: Instruction, latency: float) -> None:
        if instr.state == "done":
            return
        instr.state = "done"
        self._done_count += 1
        self._issued_on.pop(instr.iid, None)
        self._remaining.pop(instr.iid, None)
        qname = self._qname_cache.get(instr.queue)
        if qname is None:
            qname = self._qname_cache[instr.queue] = \
                ".".join(map(str, instr.queue))
        e = self._queue_latency_ewma.get(qname, latency)
        self._queue_latency_ewma[qname] = 0.9 * e + 0.1 * latency
        obs = self._obs
        if obs:
            self._obs_done(instr, qname)
        remaining, blocked = self._remaining, self._blocked
        it = instr.itype
        for dep in instr.dependents:
            rem = remaining.get(dep.iid)
            if rem is None:
                continue
            rem -= 1
            remaining[dep.iid] = rem
            if dep.iid in blocked:
                if rem == 0:
                    del blocked[dep.iid]
                    if obs:
                        dep._ready_t = time.perf_counter()
                        # last-arriving predecessor: scalar blame stamps only
                        # (an object reference would chain the whole history
                        # past retirement)
                        dep._blame_iid = instr.iid
                        dep._blame_it = it
                    if dep.tenant is None:
                        self._ready.append(dep)
                    else:
                        self._enqueue_tenant(dep)
                else:
                    self._recheck.append(dep)   # one fewer scattered dep
        tn = instr.tenant
        if tn is not None:
            self.tenant_done[tn] = self.tenant_done.get(tn, 0) + 1
            w = instr.window
            if w is not None:
                ws = self._tenant_windows.setdefault(tn, set())
                if it == InstructionType.EPOCH:
                    ws.discard(w)
                else:
                    ws.add(w)
                    if len(ws) > self.tenant_window_peak.get(tn, 0):
                        self.tenant_window_peak[tn] = len(ws)
            if getattr(instr, "_admitted", False) and it not in _PEER_WAIT:
                n = self._tenant_inflight.get(tn, 0) - 1
                self._tenant_inflight[tn] = n if n > 0 else 0
            dq = self._tenant_deferred.get(tn)
            if dq:
                cap = self.max_inflight_per_tenant
                while dq and (cap is None
                              or self._tenant_inflight.get(tn, 0) < cap):
                    self._deferred_count -= 1
                    self._enqueue_tenant(dq.popleft())
        if it == InstructionType.EPOCH and instr.command is not None:
            with self._epoch_cv:
                self._completed_epochs.add(instr.command.cid)
                if self._stamped:
                    self._epoch_done_t[instr.command.cid] = \
                        time.perf_counter()
                self._epoch_cv.notify_all()
        if it in (InstructionType.HORIZON, InstructionType.EPOCH):
            self._retire_before(instr)
            self.horizons_done += 1
            if obs:
                self._sample_lag()
            self.horizon_event.set()    # unblock a throttled scheduler

    def _obs_done(self, instr: Instruction, qname: str) -> None:
        """Wait-state attribution at completion (DESIGN.md §11.2).

        ``t_reg -> t_ready -> t_start -> t_done``: the issue latency
        ``t_start - t_reg`` decomposes exactly into the classified pending
        wait plus the queue wait, so the per-instruction histograms sum to
        the measured latency by construction.

        Under a tracer a device lane's record also carries the lane's
        launch and sync stamps.
        """
        t_done = time.perf_counter()
        t_reg = getattr(instr, "_reg_t", None)
        if t_reg is None:
            return                       # submitted before this executor
        t_ready = getattr(instr, "_ready_t", t_reg)
        t_start = getattr(instr, "_start_t", t_ready)
        if t_start < t_ready:
            t_start = t_ready           # lane stamped before the drain raced
        cls = WAIT_OF.get(getattr(instr, "_blame_it", None), WAIT_DEP)
        if self.metrics is not None:
            pending = (t_ready - t_reg) * 1e6
            queue_w = (t_start - t_ready) * 1e6
            self._h_issue.observe(pending + queue_w)
            self._h_wait[cls].observe(pending)
            self._h_queue.observe(queue_w)
        if self.tracer is not None:
            rs = self._rec_sample
            if (rs > 1 and instr.iid % rs
                    and self._issue_tracer is None):
                # standard Tracer (no issue() events): nothing to close in
                # its open-span table, so the dropped record needs no call
                self._drops_pending += 1
                return
            lane = getattr(instr, "trace_lane", None) or f"N{self.node}.{qname}"
            launched = synced = None
            if self._stamped:
                launched = instr.__dict__.pop("_launched_t", None)
                synced = instr.__dict__.pop("_synced_t", None)
                if synced is not None:
                    # keep t_start <= t_launched <= t_synced <= t_done
                    launched = max(launched, t_start)
                    synced = max(synced, launched)
                    t_done = max(t_done, synced)
            self.tracer.record(
                self.node, instr, lane, t_reg=t_reg, t_ready=t_ready,
                t_start=t_start, t_done=t_done, wait_cls=cls,
                blame_iid=getattr(instr, "_blame_iid", None),
                t_launched=launched, t_synced=synced)

    def _sample_lag(self) -> None:
        """Scheduler-lag time series, sampled at each horizon/epoch: ready-
        queue depth, in-flight count and retirement progress as counter
        tracks (lookahead occupancy and horizon lag sample scheduler-side)."""
        n = self.node
        inflight = float(len(self._remaining))
        ready = float(len(self._ready))
        m = self.metrics
        if m is not None:
            m.gauge(f"executor.N{n}.inflight", inflight)
            m.gauge(f"executor.N{n}.ready_depth", ready)
            m.gauge(f"executor.N{n}.retired", float(self._retired_count))
        tr = self.tracer
        if tr is not None:
            tr.counter(f"executor.N{n}.inflight", inflight)
            tr.counter(f"executor.N{n}.ready_depth", ready)
            if self._drops_pending and hasattr(tr, "note_sampled_out"):
                tr.note_sampled_out(self._drops_pending)
                self._drops_pending = 0

    # -- horizon-based retirement (§3.5) --------------------------------------
    def _retire_before(self, sync_instr: Instruction) -> None:
        """Drop tracking state for everything registered before ``sync_instr``.

        A horizon/epoch instruction transitively depends on every instruction
        submitted before it, so its completion proves all of them are done.
        Clearing their dependency lists breaks the chain of references that
        would otherwise keep the whole execution history alive.
        """
        log = self._retire_log
        while log and log[0] is not sync_instr and log[0].state == "done":
            old = log.popleft()
            self._registered.pop(old.iid, None)
            self._remaining.pop(old.iid, None)
            self._retired_count += 1
            old.dependencies = []
            old.dependents = []

    # -- instruction semantics ---------------------------------------------------
    def device_of(self, d: int) -> torch.device:
        """The torch device behind simulated device ``d`` (memory ``M2+d``)."""
        if not self._cuda:
            return self.device
        return torch.device("cuda", d % self._ncards)

    def _mem_device(self, mid: int) -> torch.device:
        if is_device_memory(mid):
            return self.device_of(mid - 2)
        return torch.device("cpu")

    def _arr(self, alloc: Allocation) -> torch.Tensor:
        """Backing tensor; lazily seeds M0 allocations with user init data."""
        arr = self.store.get(alloc.aid)
        if arr is None:
            init = getattr(alloc, "initial_data", None)
            if init is None:
                raise KeyError(f"allocation {alloc} not materialized on N{self.node}")
            arr = self.store[alloc.aid] = torch.from_numpy(
                np.array(init, copy=True))
        return arr

    def _account(self, mid: int, delta: int) -> None:
        with self._mem_lock:
            n = self.mem_used.get(mid, 0) + delta
            self.mem_used[mid] = n
            if n > self.mem_peak.get(mid, 0):
                self.mem_peak[mid] = n
        if self.tracer is not None:
            self.tracer.counter(f"N{self.node}.M{mid}.bytes", float(n))

    def _exec_alloc(self, instr: Instruction) -> None:
        a = instr.allocation
        if not instr.persistent:
            # a reduction accumulator scratch (the only allocations that are
            # not buffer-backed when their ALLOC is emitted): a host array
            # whatever its memory id.  ``a.bid`` cannot tell: renaming sets
            # it to None on the scheduler thread when the physical retires
            # to the free pool, which may precede this ALLOC's execution.
            arr = np.empty(a.box.shape, dtype=np.dtype(a.dtype))
        else:
            arr = torch.empty(a.box.shape, dtype=torch_dtype(a.dtype),
                              device=self._mem_device(a.mid),
                              pin_memory=self._cuda and a.mid == PINNED_HOST)
        self.store[a.aid] = arr
        self._account(a.mid, nbytes_of(arr))

    def _exec_free(self, instr: Instruction) -> None:
        # A device tensor may have been allocated on one lane's stream and
        # used on others (device ALLOC/COPY run on device lanes, SEND on the
        # host pool).  Dropping it here is safe without ``record_stream``
        # only because every instruction's GPU work has finished before it
        # is marked done (the lane waits for its stream), and FREE depends
        # on every user of the allocation.
        a = instr.allocation
        arr = self.store.pop(a.aid, None)
        if arr is not None:
            self._account(a.mid, -nbytes_of(arr))

    def _exec_copy(self, instr: Instruction) -> None:
        src, dst, box = instr.src_alloc, instr.dst_alloc, instr.copy_box
        sarr, darr = self._arr(src), self._arr(dst)
        ssl = tuple(slice(a - o, b - o) for a, b, o in
                    zip(box.min, box.max, src.box.min))
        dsl = tuple(slice(a - o, b - o) for a, b, o in
                    zip(box.min, box.max, dst.box.min))
        # asynchronous on the lane's stream; the lane waits for it
        darr[dsl].copy_(sarr[ssl], non_blocking=True)

    @staticmethod
    def _snapshot(view):
        """A private copy of ``view`` for the wire, complete on return.

        The peer may land it as soon as ``isend`` posts it, so a copy on a
        card must have finished first.  Reduction partials are host arrays
        and copy as such."""
        if isinstance(view, np.ndarray):
            return view.copy()
        out = view.clone(memory_format=torch.contiguous_format)
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    def _exec_send(self, instr: Instruction) -> None:
        alloc, box = instr.recv_alloc, instr.send_box
        arr = self._arr(alloc)
        sl = tuple(slice(a - o, b - o) for a, b, o in
                   zip(box.min, box.max, alloc.box.min))
        self.comm.isend(instr.dest, Payload(
            source=self.node, msg_id=instr.msg_id,
            transfer_id=instr.transfer_id, box=box,
            data=self._snapshot(arr[sl])))

    def _exec_coll_send(self, instr: Instruction) -> None:
        """One packed collective round message: every fragment is copied out
        of its source allocation and shipped in a single payload, so the
        message count of a round is what the schedule says it is (real byte
        accounting happens in ``Communicator.isend``)."""
        frags: list[tuple] = []
        for f in instr.coll_frags:
            arr = self._arr(f.alloc)
            if f.box is not None:
                sl = tuple(slice(a - o, b - o) for a, b, o in
                           zip(f.box.min, f.box.max, f.alloc.box.min))
                frags.append((f.key, self._snapshot(arr[sl])))
            elif f.srange is not None:       # allreduce slot-range fragment
                lo, hi = f.srange
                frags.append((f.key, self._snapshot(arr[lo:hi])))
            else:
                frags.append((f.key, self._snapshot(arr[f.slot])))
        self.comm.isend(instr.dest, Payload(
            source=self.node, msg_id=instr.msg_id,
            transfer_id=instr.transfer_id, fragments=frags))

    def _exec_fill_identity(self, instr: Instruction) -> None:
        red = instr.reduction
        arr = self._arr(instr.allocation)
        arr[...] = red.op.identity_acc(arr.shape, red.buffer.dtype)

    def _exec_local_reduce(self, instr: Instruction) -> None:
        """Fold the device partials into this node's partial accumulator.

        Every partial is a host array already (each kernel's contribution
        was brought to the host by its view), so this is the reference's
        fold; the combine-tree shape is identical.
        """
        red = instr.reduction
        op = red.op
        if instr.slot_range is not None:
            # allreduce fold-on-receive: fold the landed slot-range
            # fragment into the flat accumulator in place (the combine is
            # order-free, so the halving tree never changes a bit)
            lo, hi = instr.slot_range
            dst = self._arr(instr.dst_alloc)
            src = self._arr(instr.reduce_srcs[0])
            dst[lo:hi] = op.combine(dst[lo:hi], src) if instr.accumulate \
                else src
            return
        acc = None
        for src in instr.reduce_srcs:
            arr = self._arr(src)
            acc = arr.copy() if acc is None else op.combine(acc, arr)
        if acc is None:
            acc = op.identity_acc(red.buffer.shape, red.buffer.dtype)
        if instr.dst_slot is not None:   # collective mode: own staging slot
            self._arr(instr.dst_alloc)[instr.dst_slot] = acc
        else:
            # destination may be the buffer-shaped node partial or the
            # allreduce-mode flat slot-space accumulator
            darr = self._arr(instr.dst_alloc)
            darr[...] = acc.reshape(darr.shape)

    def _exec_global_reduce(self, instr: Instruction) -> None:
        """Fold all rank partials in canonical node order into the buffer.

        ``participants`` is the replicated-deterministic fold order; with the
        exact-sum accumulator the result is additionally partition
        independent (see reduction.py).  ``include_current`` lifts the
        buffer's previous (replicated) contents into accumulator space and
        folds them in exactly once, after the partials.  The result is
        written into the buffer's tensor (host memory, pinned with a card)
        before this returns, so the device lanes that copy it later read
        the finished value.
        """
        red = instr.reduction
        op, buf = red.op, red.buffer
        gather_arr = (self._arr(instr.src_alloc)
                      if instr.src_alloc is not None else None)
        if instr.prefolded:
            # allreduce mode: the flat accumulator already holds the fully
            # folded value for every slot — lift/finalize only
            acc = gather_arr.reshape(buf.shape)
        else:
            own = (self._arr(instr.reduce_srcs[0])
                   if instr.reduce_srcs else None)
            acc = None
            for s in instr.participants:
                if instr.slot_all:      # collective mode: own slot included
                    part = gather_arr[s]
                else:
                    part = own if s == self.node else gather_arr[s]
                acc = part.copy() if acc is None else op.combine(acc, part)
            if acc is None:                  # no participants: identity
                acc = op.identity_acc(buf.shape, buf.dtype)
        dst = instr.dst_alloc
        darr = self._arr(dst)
        box = buf.full_box
        sl = tuple(slice(a - o, b - o) for a, b, o in
                   zip(box.min, box.max, dst.box.min))
        view = darr[sl]
        if instr.include_current:
            acc = op.combine(acc, op.lift(host_array(view), buf.dtype))
        out = np.ascontiguousarray(op.finalize(acc, buf.dtype))
        view.copy_(torch.from_numpy(out).reshape(view.shape))

    def _exec_kernel(self, instr: Instruction) -> None:
        if self._slow_s:
            time.sleep(self._slow_s)     # injected straggler (fault plan)
        views = []
        for b in instr.bindings:
            arr = self._arr(b.allocation)
            views.append(BufferView(arr, b.allocation, b, self.check_bounds))
        for rb in instr.red_bindings:
            views.append(ReductionView(self._arr(rb.allocation),
                                       rb.reduction.op))
        if instr.kernel_fn is not None:
            instr.kernel_fn(instr.chunk, *views)
        if self.check_bounds:
            for v, b in zip(views, instr.bindings):
                if v.oob_min is not None:
                    raise BoundsError(
                        f"kernel '{instr.name}' accessed "
                        f"{Box(tuple(v.oob_min), tuple(v.oob_max))} outside "
                        f"declared region {b.region} of buffer "
                        f"{b.accessor.buffer.name}")

    # -- introspection -------------------------------------------------------
    def straggler_report(self) -> dict[str, float]:
        """Per-queue EWMA completion latency (straggler mitigation input)."""
        return dict(self._queue_latency_ewma)
