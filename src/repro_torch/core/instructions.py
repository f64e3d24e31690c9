# Copied from src/repro/core/instructions.py.
"""Instruction vocabulary shared by the IDAG generator and the memory layer.

The instruction types and the :class:`Instruction` node itself live in their
own module so that :mod:`repro.core.memory` (allocation lifecycle, spilling)
and :mod:`repro.core.instruction_graph` (command lowering) can both emit
instructions without a circular import.  ``instruction_graph`` re-exports
everything here, so external users keep importing from there.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from .allocation import Allocation
from .buffer import Accessor
from .reduction import Reduction
from .region import Box, Region
from .task_graph import DepKind


class InstructionType(enum.Enum):
    ALLOC = "alloc"
    COPY = "copy"
    FREE = "free"
    # budget-pressure data movement (memory.py): a SPILL copies the only
    # coherent replica of a region out of a budgeted memory before its
    # allocation is evicted; a RELOAD is the lazy copy back on next access.
    # Both execute exactly like COPY — the distinct types exist for
    # dependency auditing, tracing and overhead accounting.
    SPILL = "spill"
    RELOAD = "reload"
    SEND = "send"
    RECEIVE = "receive"
    SPLIT_RECEIVE = "split_receive"
    AWAIT_RECEIVE = "await_receive"
    # reduction pipeline (§2.2): identity-fill device scratch, combine device
    # partials per node, gather peer partials (multi-peer, pilot-driven,
    # fixed-stride slots) and fold them in canonical node order
    FILL_IDENTITY = "fill_identity"
    LOCAL_REDUCE = "local_reduce"
    GATHER_RECEIVE = "gather_receive"
    GLOBAL_REDUCE = "global_reduce"
    # collective exchange rounds (DESIGN.md §9): one COLL_SEND is one packed
    # message of one topology round (multiple block/slot fragments); a
    # COLL_RECV expects exactly one such message from one peer and lands its
    # fragments.  Transfer ids are round-tagged, so rounds of different
    # collectives interleave freely.
    COLL_SEND = "coll_send"
    COLL_RECV = "coll_recv"
    DEVICE_KERNEL = "device_kernel"
    HOST_TASK = "host_task"
    HORIZON = "horizon"
    EPOCH = "epoch"


_instr_ids = itertools.count()


@dataclass
class AccessorBinding:
    """Executor-facing: which allocation backs an accessor for one kernel."""
    accessor: Accessor
    allocation: Allocation
    region: Region                # buffer-space region the kernel may touch


@dataclass
class ReductionBinding:
    """Executor-facing: the identity-filled scratch a kernel reduces into."""
    reduction: Reduction
    allocation: Allocation        # per-device accumulator scratch


@dataclass(frozen=True)
class CollFragment:
    """One packed fragment of a collective message.

    ``key`` is the matching token the receiver expects: ``(member, slot)``
    for reduction-partial slots (member index within a fused group, slot =
    contributor rank), ``(member, lo, hi)`` for allreduce slot-range
    fragments, or a buffer-space :class:`Box` for region collectives.
    ``alloc`` is the allocation the sender reads from — or, on a
    ``COLL_RECV``'s ``coll_land`` list, the allocation the fragment lands
    into — addressed by slot index, slot range or box depending on which
    field is set.
    """

    key: object
    alloc: Allocation
    slot: Optional[int] = None          # reduction slot within ``alloc``
    box: Optional[Box] = None           # buffer-space box within ``alloc``
    srange: Optional[tuple] = None      # flat slot range [lo, hi) in alloc


@dataclass
class Pilot:
    """Pilot message: announces an inbound transfer to the receiver (§3.4).

    ``transfer_id`` is ``(task id, buffer id)`` for push traffic and
    ``(task id, buffer id, 1)`` for reduction-gather traffic, so the two
    protocols never alias; the arbiter routes by transfer id and lands
    gather payloads at the fixed-stride slot of their *source* rank rather
    than at a buffer-space offset.  ``gather`` is wire metadata only (a
    real MPI transport would select the superaccumulator datatype from
    it); the in-process arbiter treats pilots as accounting.
    """
    source: int
    target: int
    transfer_id: tuple
    box: Box                      # buffer-space box being sent
    msg_id: int
    gather: bool = False          # reduction-gather transfer (metadata)


@dataclass
class EpochAbort:
    """EPOCH_ABORT poison message: cross-node failure propagation (§10).

    A failing rank (or a watchdog that detected a dead peer) broadcasts one
    of these through the ``Communicator`` control plane; receivers abort the
    current epoch within ~1 RTT instead of stalling to the epoch timeout.
    The control plane is assumed reliable (it is not subject to the fault
    plan) — on a real transport it maps to the out-of-band error channel.
    """
    origin: int                        # rank that detected/raised the failure
    instruction: str                   # where the origin was when it failed
    cause: str                         # human-readable fault cause
    dead_peer: Optional[int] = None    # the rank believed crashed, if known


@dataclass
class Instruction:
    itype: InstructionType
    node: int
    # queue affinity: ("device", d) | ("host",) | ("comm",) — executor routing
    queue: tuple = ("host",)
    # ALLOC / FREE
    allocation: Optional[Allocation] = None
    # COPY / SPILL / RELOAD
    src_alloc: Optional[Allocation] = None
    dst_alloc: Optional[Allocation] = None
    copy_box: Optional[Box] = None           # buffer-space box to copy
    # SEND
    dest: Optional[int] = None
    msg_id: Optional[int] = None
    send_box: Optional[Box] = None
    # RECEIVE / SPLIT_RECEIVE / AWAIT_RECEIVE / GATHER_RECEIVE
    transfer_id: Optional[tuple] = None
    recv_region: Optional[Region] = None
    recv_alloc: Optional[Allocation] = None
    split_parent: Optional["Instruction"] = None
    # reductions: FILL_IDENTITY fills ``allocation``; LOCAL_REDUCE folds
    # ``reduce_srcs`` into ``dst_alloc``; GATHER_RECEIVE expects one partial
    # per rank in ``gather_sources`` landed at slot=rank in ``recv_alloc``;
    # GLOBAL_REDUCE folds slots of ``src_alloc`` (+ own partial in
    # ``reduce_srcs``) over ``participants`` in node order into ``dst_alloc``
    reduction: Optional[Reduction] = None
    reduce_srcs: tuple[Allocation, ...] = ()
    gather_sources: tuple[int, ...] = ()
    participants: tuple[int, ...] = ()
    include_current: bool = False
    # collective mode (DESIGN.md §9): LOCAL_REDUCE writes slot ``dst_slot``
    # of the staging allocation; GLOBAL_REDUCE with ``slot_all`` folds every
    # participant slot of ``src_alloc`` (own partial included).  COLL_SEND
    # carries ``coll_frags``; COLL_RECV expects keys ``coll_expect`` from
    # ``coll_source`` and lands them into ``coll_allocs``.
    dst_slot: Optional[int] = None
    slot_all: bool = False
    # allreduce mode (DESIGN.md §9): LOCAL_REDUCE with ``slot_range`` and
    # ``accumulate`` folds ``reduce_srcs[0]`` INTO ``dst_alloc[lo:hi]``
    # (fold-on-receive of one reduce-scatter fragment); GLOBAL_REDUCE with
    # ``prefolded`` takes ``src_alloc`` as the already fully folded flat
    # accumulator and only lifts/finalizes.  A COLL_RECV with ``coll_land``
    # lands each expected fragment at the slot range of its entry instead
    # of the (member, slot) addressing.
    slot_range: Optional[tuple] = None
    accumulate: bool = False
    prefolded: bool = False
    coll_frags: tuple[CollFragment, ...] = ()
    coll_allocs: tuple[Allocation, ...] = ()
    coll_expect: tuple = ()
    coll_land: tuple[CollFragment, ...] = ()
    coll_source: Optional[int] = None
    # optional tracer lane override (per-collective Perfetto tracks) — does
    # not affect executor routing, which keys on ``queue``
    trace_lane: Optional[str] = None
    # DEVICE_KERNEL / HOST_TASK
    kernel_fn: Optional[Callable] = None
    chunk: Optional[Box] = None
    bindings: tuple[AccessorBinding, ...] = ()
    red_bindings: tuple[ReductionBinding, ...] = ()
    device: Optional[int] = None
    name: str = ""
    command: Optional[object] = None          # the lowered Command, if any
    # serving-runtime tenant tag (core/memo.py): None for single-program
    # runs — the executor's fast path keys on it staying None
    tenant: Optional[str] = None
    # serving window sequence number (per tenant): lets the executor track
    # how many replayed windows are concurrently in flight (DESIGN.md §13)
    window: Optional[int] = None
    # ALLOC only, stamped at emission: whether the allocation was buffer-
    # backed (persistent) when the ALLOC was emitted.  Renaming mutates
    # ``allocation.bid`` after emission, so the verifier's leak check
    # (DESIGN.md §14) needs the emission-time value, not the current one.
    persistent: Optional[bool] = None
    iid: int = field(default_factory=lambda: next(_instr_ids))
    dependencies: list[tuple["Instruction", DepKind]] = field(default_factory=list)
    dependents: list["Instruction"] = field(default_factory=list)
    # set by the executor:
    state: str = "pending"

    @staticmethod
    def _frag_region(f: CollFragment) -> Region:
        """Allocation-space region one collective fragment addresses."""
        if f.box is not None:
            return Region.from_box(f.box)
        if f.srange is not None:
            lo, hi = f.srange
            return Region.from_box(Box((lo,), (hi,)))
        b = f.alloc.box
        s = f.slot
        return Region.from_box(Box((s,) + b.min[1:], (s + 1,) + b.max[1:]))

    def accesses(self) -> list[tuple[Allocation, Region, str]]:
        """Structured access metadata: ``(allocation, region, mode)`` triples.

        ``mode`` is ``"r"`` (read), ``"w"`` (discard-write), ``"rw"``
        (read-modify-write) or ``"red"`` (combining read-modify-write into a
        reduction accumulator: racing ``"red"`` accesses to the same
        allocation are permitted by construction — the one-writer exception,
        DESIGN.md §14).  Regions are in the coordinate space the allocation
        is addressed in: buffer space for buffer-backed allocations,
        slot-staging space for reduction scratch.  ALLOC/FREE/HORIZON/EPOCH
        perform no data access and return ``[]`` — allocation lifetime is
        carried by ``self.allocation`` instead.

        This is the single source of truth the schedule sanitizer
        (core/verify.py) and the memo hazard wiring (core/memo.py) analyze;
        an instruction type whose executor semantics touch memory not listed
        here is invisible to both.
        """
        T = InstructionType
        it = self.itype
        out: list[tuple[Allocation, Region, str]] = []

        def add(alloc: Optional[Allocation], region: Optional[Region],
                mode: str) -> None:
            if alloc is not None and region is not None:
                out.append((alloc, region, mode))

        def whole(a: Allocation) -> Region:
            return Region.from_box(a.box)

        def row(a: Allocation, s: int) -> Region:
            b = a.box
            return Region.from_box(
                Box((s,) + b.min[1:], (s + 1,) + b.max[1:]))

        if it in (T.COPY, T.SPILL, T.RELOAD):
            reg = Region.from_box(self.copy_box)
            add(self.src_alloc, reg, "r")
            add(self.dst_alloc, reg, "w")
        elif it is T.SEND:
            # ``recv_alloc`` is the *source* allocation for a SEND (the
            # field names the receiver-protocol role, not the direction)
            add(self.recv_alloc, Region.from_box(self.send_box), "r")
        elif it in (T.RECEIVE, T.SPLIT_RECEIVE):
            add(self.recv_alloc, self.recv_region, "w")
        elif it is T.AWAIT_RECEIVE:
            # the split parent is the writer; the await only observes its
            # sub-region (sibling awaits overlap would be false WW races)
            add(self.recv_alloc, self.recv_region, "r")
        elif it is T.GATHER_RECEIVE:
            for src in self.gather_sources:
                add(self.recv_alloc, row(self.recv_alloc, src), "w")
        elif it is T.FILL_IDENTITY:
            add(self.allocation, whole(self.allocation), "w")
        elif it is T.LOCAL_REDUCE:
            for a in self.reduce_srcs:
                add(a, whole(a), "r")
            d = self.dst_alloc
            if self.slot_range is not None:
                lo, hi = self.slot_range
                add(d, Region.from_box(Box((lo,), (hi,))),
                    "rw" if self.accumulate else "w")
            elif self.dst_slot is not None:
                add(d, row(d, self.dst_slot), "w")
            else:
                add(d, whole(d), "w")
        elif it is T.GLOBAL_REDUCE:
            if self.src_alloc is not None:
                add(self.src_alloc, whole(self.src_alloc), "r")
            for a in self.reduce_srcs:
                add(a, whole(a), "r")
            add(self.dst_alloc, whole(self.dst_alloc),
                "rw" if self.include_current else "w")
        elif it is T.COLL_SEND:
            for f in self.coll_frags:
                add(f.alloc, self._frag_region(f), "r")
        elif it is T.COLL_RECV:
            if self.coll_land:
                for f in self.coll_land:
                    add(f.alloc, self._frag_region(f), "w")
            elif self.recv_alloc is not None:
                add(self.recv_alloc, self.recv_region, "w")
            else:
                for key in self.coll_expect:
                    mi, slot = key[0], key[1]
                    a = self.coll_allocs[mi]
                    add(a, row(a, slot), "w")
        elif it in (T.DEVICE_KERNEL, T.HOST_TASK):
            for b in self.bindings:
                m = b.accessor.mode
                mode = ("rw" if (m.is_consumer and m.is_producer)
                        else "w" if m.is_producer else "r")
                add(b.allocation, b.region, mode)
            for rb in self.red_bindings:
                add(rb.allocation, whole(rb.allocation), "red")
        return out

    def add_dependency(self, dep: "Instruction", kind: DepKind) -> None:
        if dep is self:
            return
        for d, _ in self.dependencies:
            if d is dep:
                return
        self.dependencies.append((dep, kind))
        dep.dependents.append(self)

    def __hash__(self) -> int:
        return self.iid

    def __repr__(self) -> str:
        extra = ""
        if self.itype == InstructionType.DEVICE_KERNEL:
            extra = f":{self.name}@D{self.device}"
        elif self.itype in (InstructionType.ALLOC, InstructionType.FREE):
            extra = f":{self.allocation}"
        elif self.itype in (InstructionType.COPY, InstructionType.SPILL,
                            InstructionType.RELOAD):
            extra = (f":{self.src_alloc and self.src_alloc.aid}"
                     f"->{self.dst_alloc and self.dst_alloc.aid}")
        return f"I{self.iid}<{self.itype.value}{extra}>"
