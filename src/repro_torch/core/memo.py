# Copied from src/repro/core/memo.py; edited for device memory and replay state.
"""Schedule memoization + multi-tenant serving runtime (DESIGN.md §12).

The paper's thesis is that graph-based IRs move scheduling work off the
latency-sensitive critical path; a long-lived service handling millions of
near-identical requests takes that to its limit.  After the first few
submissions of a task-graph *shape*, TDAG→CDAG→IDAG lowering is pure
repeated work: this module caches the lowered instruction window, keyed by a
canonical shape signature, and **replays** it on subsequent submissions with
only the per-request parameters patched in — fresh instruction/epoch/
transfer ids and the new kernel closures.  Amortized scheduling cost per
request approaches the cost of one ``copy.copy`` per instruction.

Multi-tenancy is the second axis: a :class:`ServingRuntime` hosts many
concurrent client programs (*tenants*) over one communicator + executor
grid.  Each tenant owns a buffer namespace (cross-tenant buffer access is
rejected at lowering time by the MemoryManager ownership map), its own
``memory_budgets``, its own TDAG/CDAG/IDAG pipeline and its own memo cache.
Executors interleave ready instructions of different tenants round-robin
and bound per-tenant in-flight work (``max_inflight_per_tenant``).

Correctness is anchored by the bit-identical oracle tests in
``tests/test_memo.py``: a replayed window must produce exactly the bytes a
cold-lowered execution produces, on any node/device grid, reductions
included.

Replay protocol (id-renaming rules — DESIGN.md §12.3):

* every clone gets a fresh ``iid``; in-window dependency edges are remapped
  onto the clone counterparts, every out-of-window edge onto the tenant's
  *boundary* (the executed epoch of the previous window; under pipelined
  replay, of window ``m - depth``) — this serializes a tenant's windows,
  which is REQUIRED: clones share the template's
  ``Allocation`` objects ("same base addresses"), so window k+1's scratch
  ALLOC must not overtake window k's FREE;
* ``transfer_id`` tuples lead with a task id by convention — patched as
  ``(tid_map[t[0]],) + t[1:]`` with fresh global task ids, computed once
  per replay and shared by all nodes so sender and receiver agree;
* each SEND/COLL_SEND clone draws a fresh ``msg_id`` from its node's IDAG
  counter and re-posts the matching pilot with patched transfer/msg ids;
* the window epoch clone gets a fresh EPOCH ``Command`` (fresh cid) so
  ``wait_epoch`` has a unique completion token per replay;
* kernel/host closures are patched by task position, which is how
  per-request data (and ``gather`` collection closures) enter a replay.

A window is *replayable* only if its lowering reached an allocation steady
state: no persistent (buffer-backed) ALLOC/FREE, no SPILL/RELOAD, and every
scratch ALLOC balanced by an in-window FREE.  Capture waits for two
consecutive cold lowerings of the same signature with identical structural
digests (the lowering fixpoint), so warm-up windows that materialize
allocations are never cached.

Three rules of this copy are not in the reference, whose replays can give
wrong bytes or fail when a tenant's windows take several shapes in turn
(WaveSim's rotating buffers): a window lowers from the scheduler state its
predecessors left, a replay leaves that state where the last cold lowering
left it, and a cold lowering may move the allocations a template uses.

* a template records the signature of the window executed before its
  capture, and replays only after a window of that signature; otherwise the
  window lowers cold;
* a template whose persistent allocations are no longer all live is
  dropped, and its signature may be captured again;
* before a cold lowering, the windows replayed since the last one are
  lowered again without being executed (``Tenant._catch_up``), so the
  TDAG/CDAG/IDAG state is that of the executed windows.  A replay whose
  (predecessor, signature) is that of the last cold lowering returns the
  state to it, which empties the list.

Pipelined replay (``max_inflight_windows`` >= 2) follows rules of its own
too: the reference's replays race when a client does not wait for each
window before it submits the next (fault C6).  Each window's epoch waits
for the previous window's, so the boundary epoch of window ``m - depth``
covers every window before it; the hazard edges between the windows in
flight are wired for every earlier access whose region overlaps (the
reference keeps one writer per allocation and skips every access after a
window's first write, but accesses of one window to disjoint regions are
not ordered with each other); a capture enters the hazard table like any
replay, and a replay less than ``depth`` windows after a cold window syncs
on that window's epoch.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from . import allocation as _alloc_mod
from . import instructions as _instr_mod
from . import task_graph as _task_mod
from .allocation import device_memory
from .buffer import Accessor, VirtualBuffer
from .command_graph import Command, CommandGraphGenerator, CommandType
from .communicator import Communicator
from .executor import Executor, host_array
from .instruction_graph import IdagGenerator
from .instructions import (AccessorBinding, Instruction, InstructionType,
                           Pilot, ReductionBinding)
from .lookahead import LookaheadScheduler
from .observability import MetricsRegistry
from .reduction import Reduction
from .runtime import make_tracer, resolve_device
from .region import Box, Region, split_box
from .task_graph import DepKind, TaskGraph, TaskType
from .verify import ScheduleVerifier


# -- window signatures -------------------------------------------------------

@dataclass(frozen=True)
class _Call:
    """One recorded ``submit`` — structure only, no graph work done yet."""
    name: str
    index_space: Box
    accessors: tuple                 # Accessor | Reduction descriptors
    kernel_fn: Optional[Callable]
    ttype: TaskType
    split_dims: tuple[int, ...]
    granularity: tuple[int, ...]


def _region_sig(region: Region) -> tuple:
    return tuple((b.min, b.max) for b in region.boxes)


def _accessor_sig(acc: Accessor, index_space: Box, chunks: list[Box],
                  subchunks: list[Box]) -> tuple:
    """Canonical accessor shape: buffer identity + the *evaluated* range
    mapper over the full index space, every node chunk and every device
    subchunk.  Evaluating (rather than hashing the mapper object) makes two
    submissions equal exactly when lowering cannot tell them apart."""
    buf = acc.buffer
    return (buf.bid, buf.shape, str(buf.dtype), acc.mode.value,
            _region_sig(acc.mapped_region(index_space)),
            tuple(_region_sig(acc.mapped_region(c)) for c in chunks),
            tuple(_region_sig(acc.mapped_region(c)) for c in subchunks))


def _reduction_sig(red: Reduction) -> tuple:
    buf = red.buffer
    return (buf.bid, buf.shape, str(buf.dtype), red.op.name,
            bool(red.op.combine_order_free), bool(red.include_current_value))


def window_signature(calls: Sequence[_Call], *, num_nodes: int,
                     devices_per_node: int, config: tuple,
                     budgets: Optional[dict[int, int]],
                     namespace: str) -> tuple:
    """Canonical shape signature of one submission window.

    Covers task structure, evaluated ranges/accessors, grid shape, reduction
    operators, memory budgets and the tenant namespace — and deliberately
    NOT the data (kernel closures), which is patched in at replay.  Any
    difference that could change the lowered instruction stream must change
    the signature; data that cannot, must not.
    """
    call_sigs = []
    for c in calls:
        chunks = split_box(c.index_space, num_nodes, c.split_dims,
                           c.granularity)
        subchunks = [s for ch in chunks
                     for s in split_box(ch, devices_per_node, c.split_dims,
                                        c.granularity)]
        accs = tuple(_accessor_sig(a, c.index_space, chunks, subchunks)
                     for a in c.accessors if isinstance(a, Accessor))
        reds = tuple(_reduction_sig(r)
                     for r in c.accessors if isinstance(r, Reduction))
        call_sigs.append((c.ttype.value, c.name,
                          (c.index_space.min, c.index_space.max),
                          c.split_dims, c.granularity, accs, reds))
    return (tuple(call_sigs), (num_nodes, devices_per_node) + config,
            tuple(sorted((budgets or {}).items())), namespace)


# -- cached windows ----------------------------------------------------------

_SEND_TYPES = (InstructionType.SEND, InstructionType.COLL_SEND)
_SYNC_TYPES = (InstructionType.HORIZON, InstructionType.EPOCH)


def _window_digest(node_instrs: list[list[Instruction]]) -> tuple:
    """Structural digest of one lowered window.

    Scratch allocation ids are canonicalized to first-appearance order
    within the window — scratch draws a fresh global ``aid`` on every
    lowering, which must not defeat the fixpoint.  PERSISTENT (buffer-
    backed) allocations keep their raw ``aid``: a replay freezes the
    window's version→physical bindings, so capture must only fire once
    those bindings repeat exactly.  Under write renaming (DESIGN.md §13)
    a buffer's physical ping-pongs through the free pool every window —
    structurally identical, semantically alternating — and the raw-aid
    digest keeps such windows from ever reaching a (false) fixpoint.
    """
    out = []
    for instrs in node_instrs:
        canon: dict[int, int] = {}

        def _key(a):
            if a is None:
                return None
            if a.bid is not None:
                return ("p", a.bid, a.aid)
            return ("s", canon.setdefault(a.aid, len(canon)))

        sig = []
        for i in instrs:
            reads, writes = _alloc_touches(i)
            # FREE names embed the raw aid — the allocation keys already
            # identify the allocation, so keep the digest name id-free
            name = "" if i.itype == InstructionType.FREE else i.name
            sig.append((i.itype.value, name, i.queue, i.dest,
                        tuple(_key(a) for a in reads),
                        tuple(_key(a) for a in writes)))
        out.append(tuple(sig))
    return tuple(out)


def _replayable(node_instrs: list[list[Instruction]]) -> Optional[str]:
    """Why this window may NOT be replayed (None = replayable).

    Persistent (buffer-backed) ALLOC/FREE or SPILL/RELOAD mean the
    allocation pattern has not reached steady state — replaying would
    re-materialize or tear down long-lived backings.  Scratch ALLOCs must
    be balanced by in-window FREEs so each replay's alloc/free pairs nest.
    """
    for instrs in node_instrs:
        open_scratch: set[int] = set()
        for i in instrs:
            if i.itype in (InstructionType.SPILL, InstructionType.RELOAD):
                return f"{i.itype.value} in window (budget pressure)"
            if i.itype == InstructionType.ALLOC:
                if i.allocation.bid is not None:
                    return f"persistent alloc of B{i.allocation.bid}"
                open_scratch.add(i.allocation.aid)
            elif i.itype == InstructionType.FREE:
                if i.allocation.bid is not None:
                    return f"persistent free of B{i.allocation.bid}"
                open_scratch.discard(i.allocation.aid)
        if open_scratch:
            return f"unbalanced scratch allocs {sorted(open_scratch)}"
    return None


def _alloc_touches(i: Instruction) -> tuple[list, list]:
    """(read, written) allocations of one instruction, by executor semantics
    (those of :func:`_hazard_accesses`, collapsed to allocations; a
    read-modify-write counts as both).  Feeds the window digest."""
    T = InstructionType
    it = i.itype
    if it in (T.ALLOC, T.FREE):
        return [], [i.allocation]
    reads: list = []
    writes: list = []
    for a, _region, mode in i.accesses():
        if it is T.AWAIT_RECEIVE:
            writes.append(a)
        elif mode == "r":
            reads.append(a)
        elif mode == "w":
            writes.append(a)
        else:                       # "rw" / "red": read-modify-write
            reads.append(a)
            writes.append(a)

    def _dedup(lst: list) -> list:
        seen: set[int] = set()
        out = []
        for a in lst:
            if id(a) not in seen:
                seen.add(id(a))
                out.append(a)
        return out

    return _dedup(reads), _dedup(writes)


def _hazard_accesses(i: Instruction) -> list[tuple]:
    """``(allocation, region, writes)`` of one instruction, by executor
    semantics.

    Feeds the cross-window hazard wiring of pipelined replay (DESIGN.md
    §13.4): persistent allocations shared by concurrently in-flight windows
    need explicit RAW/WAR/WAW edges between windows, since replay bypasses
    the MemoryManager's producer/reader maps entirely.  Regions matter:
    instructions of one window that touch disjoint regions of an
    allocation are not ordered with each other, so a later window orders
    behind each of them whose region it overlaps.

    Derived from :meth:`Instruction.accesses` (the structured access
    metadata the schedule sanitizer also analyzes), with two deliberate
    hazard-level deviations: ALLOC/FREE write their whole allocation
    (backing-store lifetime IS a hazard between windows), and AWAIT_RECEIVE
    writes its region of the landing allocation (the arbiter materializes
    payload bytes under it, so a concurrent window's reader must order
    behind it, not beside it).
    """
    T = InstructionType
    if i.itype in (T.ALLOC, T.FREE):
        return [(i.allocation, Region.from_box(i.allocation.box), True)]
    return [(a, region, i.itype is T.AWAIT_RECEIVE or mode != "r")
            for a, region, mode in i.accesses()]


@dataclass
class _Template:
    """One captured, relocatable instruction window (the memo cache value).

    The template instructions are pristine: never submitted to an executor
    (state stays ``pending``, dependency lists intact).  Replay clones
    them, patching the parameter table; see the module docstring for the
    id-renaming rules.

    Pipelined replay (DESIGN.md §13.4) double-buffers the template's
    scratch allocations: replay ``u`` binds rename set ``u % depth`` —
    set 0 is the identity (the template's own scratch), higher sets are
    lazily cloned physicals with fresh ``aid``s — so consecutive replays
    never collide on scratch backing and can execute concurrently.  The
    previous user of a set is ``depth`` or more windows back, which the
    replay's boundary epoch covers.
    """
    node_instrs: list[list[Instruction]]
    node_pilots: list[list[Pilot]]             # per node, this window's pilots
    epoch_idx: list[int]                        # per node: window-epoch index
    tids: tuple[int, ...]                       # distinct template task ids
    tid_to_call: dict[int, int]                 # template task id -> call pos
    scratch_allocs: dict[int, object] = field(default_factory=dict)
    rename_sets: list[dict] = field(default_factory=list)
    uses: int = 0                               # replay sequence (set rotation)
    replays: int = 0
    # signature of the window executed before the capturing lowering: the
    # template's instructions assume the state that window left
    prev: Optional[tuple] = None
    # the persistent allocations the instructions use; a cold lowering that
    # frees one (a resize, an eviction) makes the template stale
    allocs: tuple = ()


@dataclass
class _CacheEntry:
    digest: Optional[tuple] = None
    template: Optional[_Template] = None
    unreplayable: Optional[str] = None          # sticky guard-failure reason


class WindowHandle:
    """Completion token of one submitted window (cold or replayed)."""

    def __init__(self, tenant: "Tenant", cids: list[Optional[int]],
                 cached: bool):
        self.tenant = tenant
        self.cached = cached                    # True = replayed from cache
        self._cids = cids
        self._done = False

    def wait(self, timeout: float = 60.0) -> None:
        """Block until the window has run on every node.  A tracer gets a
        ``serve.wait`` span whose meta ``epoch_done`` is when the last node
        completed the window."""
        if self._done:
            return
        tr = self.tenant.srv.tracer
        t0 = tr.now() if tr is not None else 0.0
        done = []
        for n, cid in enumerate(self._cids):
            if cid is None:
                continue
            ex = self.tenant.srv.executors[n]
            ex.wait_epoch(cid, timeout=timeout)
            # a serving process sees an unbounded epoch stream: drop the
            # completion token so executor epoch state stays bounded
            t = ex.forget_epoch(cid)
            if t is not None:
                done.append(t)
        self._done = True
        if tr is not None:
            meta = {"epoch_done": max(done) - tr.epoch} if done else None
            tr.span(self.tenant.lane, "serve.wait", self.tenant.name, t0,
                    tr.now(), meta)


class Tenant:
    """One client program: its own namespace, budgets, pipeline and cache.

    ``submit`` only records call structure; ``run`` closes the window,
    consults the memo cache, and either lowers cold (synchronously, on the
    calling thread — the scheduling work we are amortizing away) or replays
    the cached template.  All submission-side state is guarded by a
    per-tenant lock; different tenants submit fully concurrently.
    """

    def __init__(self, srv: "ServingRuntime", name: str,
                 memory_budgets: Optional[dict[int, int]] = None,
                 max_queued_windows: int = 8):
        self.srv = srv
        self.name = name
        self.lane = f"serve.{name}"             # the client's tracer lane
        self.memory_budgets = dict(memory_budgets or {})
        self._lock = threading.RLock()
        self.tdag = TaskGraph(horizon_step=srv.horizon_step,
                              fuse_reductions=srv.reduction_fusion)
        self.cdags = [CommandGraphGenerator(srv.num_nodes, retire_for=n,
                                            collectives=srv.collectives,
                                            allreduce=srv.reduction_allreduce)
                      for n in range(srv.num_nodes)]
        self.idags = [IdagGenerator(n, srv.devices_per_node, d2d=srv.d2d,
                                    retire=True,
                                    budgets=self.memory_budgets or None,
                                    metrics=srv.metrics_registry,
                                    namespace=name,
                                    buffer_owner=srv._buffer_owner,
                                    renaming=srv.renaming)
                      for n in range(srv.num_nodes)]
        self.lookaheads = [LookaheadScheduler(self.idags[n],
                                              enabled=srv.lookahead,
                                              retire_compiled=True,
                                              metrics=srv.metrics_registry)
                           for n in range(srv.num_nodes)]
        self._sent = 0                      # lifetime task indices broadcast
        self._calls: list[_Call] = []
        # memo cache in LRU order (satellite of DESIGN.md §13): bounded by
        # ``srv.memo_cache_max`` entries, least-recently-hit evicted first
        self._memo: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        # the executed epochs every out-of-window replay edge remaps onto
        # (DESIGN.md §13.4): ``depth`` windows of this tenant may be in
        # flight at once, and window ``m`` boundary-syncs on epoch(m -
        # depth), the oldest of the ring of the last ``depth`` window epochs
        # per node (starting at the bootstrap init epoch).  Under pipelining
        # each window's epoch also waits for the previous window's, so
        # epoch(m - depth) covers every window before it; depth 1 syncs on
        # epoch(m - 1).
        self.depth = max(1, srv.max_inflight_windows)
        self._window_seq = 0
        self._ring: list[deque[Instruction]] = []
        # per node, (window, epoch) of the newest cold window: its
        # accesses are not in the hazard table, so a replay less than
        # ``depth`` windows after it syncs on its epoch instead of the ring
        self._cold: list[Optional[tuple[int, Instruction]]] = [
            None] * srv.num_nodes
        # per-node cross-window hazard table: persistent allocation id ->
        # (window, clone, region, writes) of each access by the replays
        # (captures included) of the last ``depth - 1`` windows
        self._hazards: list[dict[int, list[tuple]]] = [
            {} for _ in range(srv.num_nodes)]
        # pinned gather collection buffers: bid -> (ndarray, closure), so
        # repeated gathers replay the SAME closure instead of re-anchoring
        # a fresh one per call (ROADMAP serving follow-up)
        self._gather_pins: dict[int, tuple] = {}
        # submission-side backpressure: run() blocks on the window
        # ``max_queued_windows`` back, bounding blocked-instruction state
        # held inside the executors per tenant
        self._inflight: deque[WindowHandle] = deque()
        self.max_queued_windows = max_queued_windows
        self.lowered_windows = 0
        self.replayed_windows = 0
        # signature of the last executed window, (predecessor, signature) of
        # the last cold-lowered one, and the calls of the windows replayed
        # since then, which the scheduler layers have not seen
        self._prev_sig: Optional[tuple] = None
        self._lowered_key: Optional[tuple] = None
        self._unlowered: list[list[_Call]] = []
        # what ``_catch_up`` lowered: windows, TDAG tasks, instructions
        self.caught_up = dict(windows=0, tasks=0, instructions=0)
        # bootstrap: the IDAG's construction-time init epoch must execute
        for n in range(srv.num_nodes):
            boot = list(self.idags[n].instructions)
            for i in boot:
                i.tenant = name
            self._ring.append(deque([self.idags[n]._init_epoch],
                                    maxlen=self.depth))
            if srv.verifier is not None:
                srv.verifier.capture(n, boot)
            srv.executors[n].submit(boot)

    # -- client API --------------------------------------------------------
    def buffer(self, shape: Sequence[int], dtype=np.float64, *,
               name: str = "", init: Optional[np.ndarray] = None
               ) -> VirtualBuffer:
        buf = VirtualBuffer(shape=tuple(shape), dtype=np.dtype(dtype),
                            name=f"{self.name}/{name}" if name else "",
                            initial_value=init)
        if not name:
            buf.name = f"{self.name}/{buf.name}"
        self.srv._buffer_owner[buf.bid] = self.name
        return buf

    def submit(self, name: str, index_space, accessors: Sequence,
               kernel_fn: Callable | None = None, *,
               ttype: TaskType = TaskType.KERNEL,
               split_dims: Sequence[int] = (0,),
               granularity: Sequence[int] = (1,)) -> None:
        """Record one command group for the current window (no lowering)."""
        if not isinstance(index_space, Box):
            index_space = Box.full(tuple(index_space))
        with self._lock:
            self._calls.append(_Call(name, index_space, tuple(accessors),
                                     kernel_fn, ttype, tuple(split_dims),
                                     tuple(granularity)))

    def run(self, timeout: float = 60.0) -> WindowHandle:
        """Close the current window and submit it (cached or cold)."""
        with self._lock:
            calls, self._calls = self._calls, []
            while len(self._inflight) >= self.max_queued_windows:
                self._inflight.popleft().wait(timeout=timeout)
            handle = self._run_window(calls)
            self._inflight.append(handle)
            return handle

    def gather(self, buf: VirtualBuffer, timeout: float = 60.0) -> np.ndarray:
        """Assemble the buffer on the caller's side (itself memoizable).

        The collection target is a *pinned* per-buffer ndarray + closure,
        created once and replayed on every subsequent gather — so repeat
        gathers hit the memo cache with a byte-identical parameter table
        instead of re-anchoring a fresh closure per call.  The caller gets
        an independent copy of the pinned buffer.
        """
        from .buffer import read as read_acc
        from .range_mapper import one_to_one
        with self._lock:
            pin = self._gather_pins.get(buf.bid)
            if pin is None:
                out = np.empty(buf.shape, dtype=buf.dtype)
                lock = threading.Lock()

                def collect(chunk: Box, view, _out=out, _lock=lock) -> None:
                    data = host_array(view.get(chunk))
                    sl = tuple(slice(a, b)
                               for a, b in zip(chunk.min, chunk.max))
                    with _lock:
                        _out[sl] = data

                pin = self._gather_pins[buf.bid] = (out, collect)
            out, collect = pin
            self.submit(f"gather {buf.name}", buf.shape,
                        [read_acc(buf, one_to_one())], collect,
                        ttype=TaskType.HOST)
            self.run(timeout=timeout).wait(timeout=timeout)
            self.drain(timeout=timeout)
            return np.array(out, copy=True)

    def drain(self, timeout: float = 60.0) -> None:
        """Wait for every submitted window of this tenant to complete."""
        with self._lock:
            while self._inflight:
                self._inflight.popleft().wait(timeout=timeout)

    # -- window machinery --------------------------------------------------
    def _signature(self, calls: list[_Call]) -> tuple:
        return window_signature(calls, num_nodes=self.srv.num_nodes,
                                devices_per_node=self.srv.devices_per_node,
                                config=self.srv._config_sig,
                                budgets=self.memory_budgets,
                                namespace=self.name)

    def _run_window(self, calls: list[_Call]) -> WindowHandle:
        srv = self.srv
        m = srv.metrics_registry
        entry: Optional[_CacheEntry] = None
        sig: Optional[tuple] = None
        if srv.memo:
            sig = self._signature(calls)
            entry = self._memo.get(sig)
            if entry is None:
                entry = self._memo[sig] = _CacheEntry()
                cap = srv.memo_cache_max
                if cap is not None:
                    while len(self._memo) > cap:
                        self._memo.popitem(last=False)
                        if m is not None:
                            m.counter("memo.evictions")
                            m.counter(f"serve.{self.name}.memo_evictions")
            else:
                self._memo.move_to_end(sig)
        prev, self._prev_sig = self._prev_sig, sig
        if (entry is not None and entry.template is not None
                and not all(a.live for a in entry.template.allocs)):
            entry.template = entry.digest = None
        tr = srv.tracer
        if (entry is not None and entry.template is not None
                and entry.template.prev == prev):
            t0 = time.perf_counter()
            handle = self._replay(entry.template, calls)
            if m is not None:
                m.counter("memo.hits")
                m.counter(f"serve.{self.name}.hits")
            t1 = time.perf_counter()
            if m is not None:
                m.observe("memo.patch_us", (t1 - t0) * 1e6)
            if tr is not None:
                tr.span(self.lane, "serve.replay", self.name, t0 - tr.epoch,
                        t1 - tr.epoch)
            if (prev, sig) == self._lowered_key:
                self._unlowered.clear()
            else:
                self._unlowered.append(calls)
            self.replayed_windows += 1
            entry.template.replays += 1
            return handle
        if m is not None and srv.memo:
            m.counter("memo.misses")
            m.counter(f"serve.{self.name}.misses")
        if tr is None:
            return self._run_cold(calls, entry, prev, sig)
        t0 = tr.now()
        handle = self._run_cold(calls, entry, prev, sig)
        tr.span(self.lane, "serve.lower", self.name, t0, tr.now())
        return handle

    def _run_cold(self, calls: list[_Call], entry: Optional[_CacheEntry],
                  prev: Optional[tuple], sig: Optional[tuple]) -> WindowHandle:
        """A memo miss: lower the window, capture it once its lowering
        has reached the fixpoint, and submit it."""
        srv, m = self.srv, self.srv.metrics_registry
        self._catch_up()
        node_instrs, node_pilots, cids, tid_to_call = self._lower(calls)
        self._lowered_key = (prev, sig)
        self.lowered_windows += 1
        if (entry is not None and entry.template is None
                and entry.unreplayable is None):
            digest = _window_digest(node_instrs)
            if entry.digest is not None and digest == entry.digest:
                # lowering fixpoint reached: two consecutive cold lowerings
                # of this signature were structurally identical — capture
                why = _replayable(node_instrs)
                if why is None:
                    entry.template = self._capture(node_instrs, node_pilots,
                                                   tid_to_call, prev)
                    # the capturing lowering executes as a CLONE so the
                    # template instructions stay pristine
                    return self._replay(entry.template, calls, identity=True)
                entry.unreplayable = why
                if m is not None:
                    m.counter("memo.unreplayable")
            entry.digest = digest
        # cold path: execute the lowered window directly
        wseq = self._window_seq
        self._window_seq += 1
        for n in range(srv.num_nodes):
            self._submit_window(n, node_instrs[n], node_pilots[n], wseq)
        return WindowHandle(self, cids, cached=False)

    def _catch_up(self) -> None:
        """Lower the windows replayed since the last cold lowering, in
        order, without executing them: their instructions are marked as
        template instructions, so ``_submit_window`` rewires edges onto
        them to the executed boundary, and their pilots are dropped.  Each
        lowers as its template did (the lowering fixpoint), so it must move
        no allocation; one that does would need executing."""
        for calls in self._unlowered:
            tasks0 = self.tdag.task_count
            instrs0 = sum(g.emitted_count for g in self.idags)
            node_instrs, _pilots, _cids, _ = self._lower(calls)
            for instrs in node_instrs:
                for i in instrs:
                    i._memo_template = True
            self.caught_up["windows"] += 1
            self.caught_up["tasks"] += self.tdag.task_count - tasks0
            self.caught_up["instructions"] += (
                sum(g.emitted_count for g in self.idags) - instrs0)
            why = _replayable(node_instrs)
            if why is not None:
                raise RuntimeError(
                    f"tenant '{self.name}': a replayed window lowers to "
                    f"another allocation pattern ({why})")
        self._unlowered.clear()

    def _lower(self, calls: list[_Call]):
        """Cold TDAG→CDAG→IDAG lowering of one window, synchronously on the
        calling thread (the cost the memo cache amortizes away)."""
        srv, tdag = self.srv, self.tdag
        call_tasks = []
        for c in calls:
            call_tasks.append(tdag.submit(
                c.name, c.index_space, c.accessors, c.kernel_fn,
                ttype=c.ttype, split_dims=c.split_dims,
                granularity=c.granularity))
        epoch_task = tdag.emit_epoch("window")
        tid_to_call = {t.tid: pos for pos, t in enumerate(call_tasks)}
        N = srv.num_nodes
        tr = srv.tracer
        node_instrs: list[list[Instruction]] = [[] for _ in range(N)]
        cids: list[Optional[int]] = [None] * N
        newly = tdag.tasks[self._sent - tdag._base:]
        for task in newly:
            self._sent += 1
            if task.ttype == TaskType.EPOCH and task.name == "init":
                continue
            for n in range(N):
                t0 = tr.now() if tr is not None else 0.0
                cmds = self.cdags[n].process(task)
                t1 = tr.now() if tr is not None else 0.0
                for cmd in cmds:
                    if cmd.node != n:
                        continue
                    if (cmd.ctype == CommandType.EPOCH
                            and task is epoch_task):
                        cids[n] = cmd.cid
                    node_instrs[n].extend(self.lookaheads[n].push(cmd))
                if tr is not None:
                    meta = {"tid": task.tid, "node": n}
                    tr.span(self.lane, "sched.cdag", task.name, t0, t1, meta)
                    tr.span(self.lane, "sched.idag", task.name, t1, tr.now(),
                            meta)
        tdag.retire_to(self._sent)
        # the window ends in an epoch, so the lookahead flushed completely:
        # each IDAG's pilot list is exactly this window's pilots
        node_pilots: list[list[Pilot]] = []
        for n in range(N):
            pilots = self.idags[n].pilots
            node_pilots.append(list(pilots))
            del pilots[:]
        return node_instrs, node_pilots, cids, tid_to_call

    def _submit_window(self, n: int, instrs: list[Instruction],
                       pilots: list[Pilot], wseq: int) -> None:
        """Execute a cold-lowered window: rewire edges that point at never-
        executed template instructions onto the executed boundary, tag the
        tenant, post pilots, and advance the boundary.

        Under pipelined replay a cold window may run while up to ``depth``
        replayed windows are still in flight; its accesses stay out of the
        hazard table, so its rewired edges sync on the previous window's
        epoch (which covers every earlier window) and the replays of the
        next ``depth - 1`` windows sync on its epoch (``_boundary``).
        """
        pipelined = self.depth > 1
        prev_epoch = self._ring[n][-1]
        if pipelined:
            self._hazards[n].clear()
        epoch_instr = None
        for i in instrs:
            i.tenant = self.name
            i.window = wseq
            if any(getattr(d, "_memo_template", False)
                   for d, _ in i.dependencies):
                i.dependencies = [(d, k) for d, k in i.dependencies
                                  if not getattr(d, "_memo_template", False)]
                i.add_dependency(prev_epoch, DepKind.SYNC)
            if i.itype == InstructionType.EPOCH:
                epoch_instr = i
        for p in pilots:
            self.srv.comm.post_pilot(p)
        if epoch_instr is not None:
            if pipelined:
                epoch_instr.add_dependency(prev_epoch, DepKind.SYNC)
            self._cold[n] = (wseq, epoch_instr)
            self._ring[n].append(epoch_instr)
        if self.srv.verifier is not None:
            self.srv.verifier.capture_pilots(pilots)
            span = self.srv.verifier.capture(n, instrs)
            self.srv.executors[n].submit(instrs)
            if self.srv.verifier.mode == "window":
                self.srv.verifier.verify_window(n, span)
            return
        self.srv.executors[n].submit(instrs)

    def _capture(self, node_instrs, node_pilots, tid_to_call,
                 prev: Optional[tuple]) -> _Template:
        tids: list[int] = []
        seen: set[int] = set()
        epoch_idx: list[int] = []
        scratch: dict[int, object] = {}
        for instrs in node_instrs:
            e = -1
            for idx, i in enumerate(instrs):
                i._memo_template = True
                if i.itype == InstructionType.EPOCH:
                    e = idx
                elif (i.itype == InstructionType.ALLOC
                        and i.allocation.bid is None):
                    scratch[i.allocation.aid] = i.allocation
                t = i.transfer_id
                if t is not None and t[0] not in seen:
                    seen.add(t[0])
                    tids.append(t[0])
            epoch_idx.append(e)
        # stamp each instruction with its accesses to PERSISTENT allocations
        # (scratch is template-private per rename set, so excluded) — drives
        # the cross-window hazard wiring of pipelined replay
        allocs: dict[int, object] = {}
        for instrs in node_instrs:
            for i in instrs:
                hz = []
                for a, region, w in _hazard_accesses(i):
                    if a.aid not in scratch:
                        allocs[a.aid] = a
                        hz.append((a.aid, region, w))
                i._memo_hazards = tuple(hz)
        for pilots in node_pilots:
            for p in pilots:
                if p.transfer_id[0] not in seen:
                    seen.add(p.transfer_id[0])
                    tids.append(p.transfer_id[0])
        return _Template(node_instrs=node_instrs, node_pilots=node_pilots,
                         epoch_idx=epoch_idx, tids=tuple(tids),
                         tid_to_call=dict(tid_to_call),
                         scratch_allocs=scratch, prev=prev,
                         allocs=tuple(allocs.values()))

    def _rename_map(self, tpl: _Template, sidx: int) -> dict:
        """Rename set ``sidx`` of a template's scratch allocations.

        Set 0 is the identity (the template's own scratch objects); higher
        sets are lazily built clones with fresh ``aid``s, so two concurrent
        replays bound to different sets never alias scratch backing in the
        executor stores.  Sets are cached on the template and reused
        round-robin (``uses % depth``) — safe because the ring boundary
        guarantees the previous user of a set has fully completed.
        """
        while len(tpl.rename_sets) <= sidx:
            k = len(tpl.rename_sets)
            if k == 0:
                tpl.rename_sets.append({})
            else:
                m: dict[int, object] = {}
                for aid, a in tpl.scratch_allocs.items():
                    na = copy.copy(a)
                    na.aid = next(_alloc_mod._alloc_ids)
                    na.alloc_instr = None
                    na.hazards = []
                    m[aid] = na
                tpl.rename_sets.append(m)
        return tpl.rename_sets[sidx]

    @staticmethod
    def _remap_clone(c: Instruction, amap: dict) -> None:
        """Point one clone's allocation references at a rename set."""
        for f in ("allocation", "src_alloc", "dst_alloc", "recv_alloc"):
            a = getattr(c, f)
            if a is not None and a.aid in amap:
                setattr(c, f, amap[a.aid])
        if c.reduce_srcs:
            c.reduce_srcs = tuple(amap.get(a.aid, a) for a in c.reduce_srcs)
        if c.coll_allocs:
            c.coll_allocs = tuple(amap.get(a.aid, a) for a in c.coll_allocs)
        if c.coll_frags:
            c.coll_frags = tuple(
                dataclasses.replace(f, alloc=amap[f.alloc.aid])
                if f.alloc.aid in amap else f
                for f in c.coll_frags)
        if c.coll_land:
            c.coll_land = tuple(
                dataclasses.replace(f, alloc=amap[f.alloc.aid])
                if f.alloc.aid in amap else f
                for f in c.coll_land)
        if c.bindings:
            c.bindings = tuple(
                AccessorBinding(b.accessor, amap[b.allocation.aid], b.region)
                if b.allocation.aid in amap else b
                for b in c.bindings)
        if c.red_bindings:
            c.red_bindings = tuple(
                ReductionBinding(rb.reduction, amap[rb.allocation.aid])
                if rb.allocation.aid in amap else rb
                for rb in c.red_bindings)

    def _boundary(self, n: int, wseq: int) -> Instruction:
        """The epoch that window ``wseq``'s replay on node ``n`` syncs on:
        that of window ``wseq - depth``, or of the newest cold window if it
        is later (depth 1: the previous window's)."""
        cold = self._cold[n]
        if cold is not None and cold[0] > wseq - self.depth:
            return cold[1]
        return self._ring[n][0]

    def _replay(self, tpl: _Template, calls: list[_Call], *,
                identity: bool = False) -> WindowHandle:
        """Instantiate a cached window: clone + patch + submit.

        ``identity=True`` is the capture submission itself: the very
        lowering that produced the template still has to execute once, with
        its original ids (its pilots and transfer ids are already the
        template's) — so the parameter table maps every id to itself.

        Pipelined replay (``depth > 1``, DESIGN.md §13.4): instead of
        serializing behind the previous window's epoch, a replay boundary-
        syncs on the OLDEST ring epoch (window ``m`` waits for window
        ``m - depth`` and, through the epoch chain, every window before
        it), binds rename set ``uses % depth`` for scratch, and wires
        RAW/WAR/WAW edges against every access of the windows in between
        whose region overlaps, so only truly conflicting instructions of
        overlapping windows serialize.  The capture submission takes part
        like any replay.
        """
        srv = self.srv
        N = srv.num_nodes
        pipelined = self.depth > 1
        # one tid map for the whole replay: sender and receiver nodes must
        # agree on the patched transfer ids
        if identity:
            tid_map = {t: t for t in tpl.tids}
        else:
            tid_map = {t: next(_task_mod._task_ids) for t in tpl.tids}
        # identity replay must keep the template's own allocation objects
        # (its ALLOCs carry them), so it always binds the identity set 0
        sidx = 0 if (identity or not pipelined) else tpl.uses % self.depth
        amap = self._rename_map(tpl, sidx) if pipelined else {}
        tpl.uses += 1
        wseq = self._window_seq
        self._window_seq += 1
        cut = wseq - self.depth          # oldest window the boundary covers
        cids: list[Optional[int]] = [None] * N
        for n in range(N):
            idag = self.idags[n]
            clones: dict[int, Instruction] = {}
            out: list[Instruction] = []
            msg_map: dict[int, int] = {}
            boundary = self._boundary(n, wseq)
            hazards = self._hazards[n]
            accessed: list[tuple] = []
            for i in tpl.node_instrs[n]:
                c = copy.copy(i)
                c.iid = next(_instr_mod._instr_ids)
                c.dependencies = []
                c.dependents = []
                c.state = "pending"
                c.tenant = self.name
                c.window = wseq
                c._memo_template = False
                if c.transfer_id is not None:
                    t = c.transfer_id
                    c.transfer_id = (tid_map[t[0]],) + t[1:]
                if c.msg_id is not None:
                    nm = c.msg_id if identity else next(idag._msg_ids)
                    msg_map[i.msg_id] = nm
                    c.msg_id = nm
                if c.split_parent is not None:
                    c.split_parent = clones[c.split_parent.iid]
                if (not identity and c.itype == InstructionType.EPOCH
                        and c.command is not None):
                    c.command = Command(CommandType.EPOCH, node=n, task=None)
                if (c.itype in (InstructionType.DEVICE_KERNEL,
                                InstructionType.HOST_TASK)
                        and c.command is not None
                        and c.command.task is not None):
                    pos = tpl.tid_to_call.get(c.command.task.tid)
                    if pos is not None and pos < len(calls):
                        c.kernel_fn = calls[pos].kernel_fn
                if amap:
                    self._remap_clone(c, amap)
                needs_boundary = not i.dependencies
                for d, k in i.dependencies:
                    dc = clones.get(d.iid)
                    if dc is not None:
                        c.add_dependency(dc, k)
                    else:
                        needs_boundary = True
                if needs_boundary:
                    c.add_dependency(boundary, _task_mod.DepKind.SYNC)
                if pipelined:
                    # cross-window hazards on persistent allocations,
                    # against the windows after the boundary's
                    for aid, region, writes in i._memo_hazards:
                        for s, d, r, w in hazards.get(aid, ()):
                            if (s > cut and (writes or w)
                                    and region.overlaps(r)):
                                c.add_dependency(
                                    d, DepKind.OUTPUT if writes and w
                                    else DepKind.ANTI if writes
                                    else DepKind.TRUE)
                        accessed.append((aid, (wseq, c, region, writes)))
                clones[i.iid] = c
                out.append(c)
            e = tpl.epoch_idx[n]
            if e >= 0:
                epoch_clone = clones[tpl.node_instrs[n][e].iid]
                cids[n] = (epoch_clone.command.cid
                           if epoch_clone.command is not None else None)
                if pipelined:
                    epoch_clone.add_dependency(self._ring[n][-1],
                                               DepKind.SYNC)
                self._ring[n].append(epoch_clone)
            if pipelined:
                # keep the entries the next window can reach
                for aid in {aid for aid, _ in accessed}:
                    hazards[aid] = [x for x in hazards.get(aid, ())
                                    if x[0] > cut + 1]
                for aid, entry in accessed:
                    hazards[aid].append(entry)
            new_pilots = []
            for p in tpl.node_pilots[n]:
                t = p.transfer_id
                new_pilots.append(Pilot(
                    source=p.source, target=p.target,
                    transfer_id=(tid_map[t[0]],) + t[1:], box=p.box,
                    msg_id=msg_map.get(p.msg_id, p.msg_id), gather=p.gather))
            for p in new_pilots:
                srv.comm.post_pilot(p)
            if srv.verifier is not None:
                srv.verifier.capture_pilots(new_pilots)
                span = srv.verifier.capture(n, out)
                srv.executors[n].submit(out)
                if srv.verifier.mode == "window":
                    srv.verifier.verify_window(n, span)
            else:
                srv.executors[n].submit(out)
        return WindowHandle(self, cids, cached=not identity)


class ServingRuntime:
    """Long-lived multi-tenant runtime with schedule memoization.

    One communicator + per-node executor grid shared by every tenant; the
    per-program scheduler layers (TDAG/CDAG/IDAG/lookahead) are per-tenant
    and run synchronously on the submitting client thread — on a memo-cache
    hit they are not run at all.

    Device memories live on the CUDA card by default; ``device="cpu"`` keeps
    every memory on the host.  A CUDA request without a card raises.
    """

    def __init__(self, num_nodes: int = 1, devices_per_node: int = 1, *,
                 device="cuda",
                 memo: bool = True, lookahead: bool = True, d2d: bool = True,
                 collectives: bool = True, reduction_fusion: bool = True,
                 reduction_allreduce: bool = True, horizon_step: int = 4,
                 queues_per_device: int = 2, host_threads: int = 4,
                 max_inflight_per_tenant: Optional[int] = None,
                 max_inflight_windows: int = 1,
                 memo_cache_max: Optional[int] = None,
                 renaming: bool = False,
                 metrics: bool = True, trace: bool | str = False,
                 record_sample: int = 1, reliable: bool = True,
                 verify: str = "off"):
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.devices_per_node = devices_per_node
        self.memo = memo
        self.lookahead = lookahead
        self.d2d = d2d
        self.collectives = collectives
        self.reduction_fusion = reduction_fusion and collectives
        self.reduction_allreduce = reduction_allreduce and collectives
        self.horizon_step = horizon_step
        # DESIGN.md §13: how many replayed windows of one tenant may be in
        # flight concurrently (1 = serialized, the pre-renaming behavior)
        self.max_inflight_windows = max(1, max_inflight_windows)
        # memo-template LRU cap per tenant (None = unbounded)
        self.memo_cache_max = memo_cache_max
        self.renaming = renaming
        self.tracer = make_tracer(trace, record_sample=record_sample)
        self.metrics_registry = MetricsRegistry() if metrics else None
        # grid-shape part of every window signature: anything here that
        # changes lowering output MUST invalidate cached windows
        self._config_sig = (d2d, self.collectives, self.reduction_fusion,
                            self.reduction_allreduce, horizon_step, lookahead,
                            renaming)
        self._buffer_owner: dict[int, str] = {}
        # schedule sanitizer (DESIGN.md §14) over every submitted window —
        # including memo-replay clones and their cross-window re-anchored
        # edges, the first structural check that path has ever had.  No
        # budget model here: replay clones are not charged to a fresh
        # compile-time model, and budgets are per-tenant.
        if verify not in ("off", "final", "window"):
            raise ValueError(
                f"verify must be 'off', 'final' or 'window', got {verify!r}")
        self.verifier: Optional[ScheduleVerifier] = None
        if verify != "off":
            self.verifier = ScheduleVerifier(num_nodes, mode=verify,
                                             metrics=self.metrics_registry)
        self.comm = Communicator(num_nodes, reliable=reliable,
                                 tracer=self.tracer,
                                 metrics=self.metrics_registry)
        self.executors = [
            Executor(n, devices_per_node, self.comm, device=self.device,
                     queues_per_device=queues_per_device,
                     host_threads=host_threads, tracer=self.tracer,
                     metrics=self.metrics_registry,
                     max_inflight_per_tenant=max_inflight_per_tenant)
            for n in range(num_nodes)]
        self.tenants: dict[str, Tenant] = {}
        self._tenant_lock = threading.Lock()
        self._shut = False

    def tenant(self, name: str, *,
               memory_budgets: Optional[dict[int, int]] = None,
               device_memory_budget: Optional[int] = None,
               max_queued_windows: int = 8) -> Tenant:
        budgets = dict(memory_budgets or {})
        if device_memory_budget is not None:
            for d in range(self.devices_per_node):
                budgets.setdefault(device_memory(d), device_memory_budget)
        with self._tenant_lock:
            if name in self.tenants:
                raise ValueError(f"tenant '{name}' already exists")
            t = self.tenants[name] = Tenant(
                self, name, memory_budgets=budgets,
                max_queued_windows=max_queued_windows)
        return t

    # -- observability -----------------------------------------------------
    def memo_stats(self) -> dict:
        """Cache effectiveness + per-tenant window counters."""
        snap = (self.metrics_registry.snapshot()
                if self.metrics_registry is not None else
                dict(counters={}, histograms={}))
        counters = snap.get("counters", {})
        return dict(
            hits=counters.get("memo.hits", 0),
            misses=counters.get("memo.misses", 0),
            unreplayable=counters.get("memo.unreplayable", 0),
            evictions=counters.get("memo.evictions", 0),
            patch_us=snap.get("histograms", {}).get("memo.patch_us"),
            tenants={name: dict(lowered=t.lowered_windows,
                                replayed=t.replayed_windows,
                                caught_up=dict(t.caught_up),
                                tasks=t.tdag.task_count,
                                instructions=sum(g.emitted_count
                                                 for g in t.idags),
                                done={n: self.executors[n].tenant_done
                                          .get(name, 0)
                                      for n in range(self.num_nodes)},
                                window_peak={n: self.executors[n]
                                                 .tenant_window_peak
                                                 .get(name, 0)
                                             for n in range(self.num_nodes)})
                     for name, t in self.tenants.items()})

    def metrics(self) -> dict:
        snap = (self.metrics_registry.snapshot()
                if self.metrics_registry is not None
                else dict(counters={}, gauges={}, histograms={}))
        snap["memo"] = self.memo_stats()
        return snap

    def verify_now(self):
        """Finalize the schedule sanitizer over everything captured so far
        and raise :class:`~repro.core.verify.VerificationError` on issues.

        Call after the tenants of interest have drained, so every submitted
        window (cold, cached-replay, bootstrap) has been captured.
        """
        if self.verifier is None:
            raise RuntimeError("verify_now() needs ServingRuntime(verify=...)")
        report = self.verifier.finalize()
        self.verifier.check()
        return report

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        for t in self.tenants.values():
            try:
                t.drain(timeout=30.0)
            except Exception:       # noqa: BLE001 — teardown is best-effort
                pass
        for ex in self.executors:
            ex.shutdown()
        self.comm.drop_in_flight()
        if self.tracer is not None:
            self.tracer.close()
        if self.tracer is not None and self.metrics_registry is not None:
            self.metrics_registry.export_counters(self.tracer)

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
