"""Communicator: peer-to-peer transfers + pilot messages (paper §3.4/§4.2).

Port of ``src/repro/core/communicator.py``: payloads carry torch tensors and
the landing paths copy into the executor's store tensors.  Reduction partials
travel as host numpy arrays (the executor keeps every reduction scratch on
the host) and land into numpy slots and slot ranges.

Faithfully models the MPI-level protocol: senders transmit *pilot messages*
(source, transfer id, box, message id) ahead of the payload; the receiver's
*receive arbitration* state machine matches pilots against pending
``receive`` / ``split receive`` instructions and "posts the Irecv" — here,
registers the landing slice — as soon as source and geometry are known.  An
``await receive`` completes when its subregion is fully covered by landed
payloads, regardless of inbound geometry (cases a/b/c in §3.4).

The wire is an in-process thread-safe mailbox (one real CPU; see DESIGN.md
§2).  On a real deployment the same interface maps to MPI/ICI transports.

Resilient transport (DESIGN.md §10): with ``reliable=True`` every payload is
sequence-numbered per (source, target) channel and kept in the sender's
retransmit queue until the receiver acks it.  ``pump`` — called from each
executor's main loop — drains inbound acks and retransmits overdue entries
with exponential backoff; after ``max_retries`` unacked attempts it reports
a :class:`TransportError`.  The receiver side (``ReceiveArbiter``) acks every
delivered copy and suppresses duplicates by (channel, seq), so landing is
idempotent and any non-crash fault schedule is invisible to the program.
A :class:`FaultPlan` is consulted at the delivery points; the control plane
(acks, EPOCH_ABORT, heartbeats) is deliberately not faulted.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .faults import FaultPlan, TransportError
from .instruction_graph import EpochAbort, Instruction, InstructionType, Pilot
from .region import Box, Region


@dataclass
class Payload:
    source: int
    msg_id: int
    # (task id, buffer id) for push traffic; (task id, buffer id, 1) for
    # reduction-gather traffic; round-tagged (tid, bid, 2|3, round) for
    # collective rounds (see instruction_graph.Pilot / DESIGN.md §9)
    transfer_id: tuple
    box: Optional[Box] = None
    data: Optional[torch.Tensor | np.ndarray] = None
    # collective rounds ship ONE packed message of (key, tensor) fragments:
    # key = (member, slot) for reduction partials, a buffer-space Box for
    # region blocks — matching what the peer's COLL_RECV expects
    fragments: Optional[list[tuple]] = None
    # reliable-transport sequence number within the (source, target) channel;
    # None on an unreliable wire (assigned by ``Communicator.isend``)
    seq: Optional[int] = None

    def nbytes(self) -> int:
        if self.fragments is not None:
            return sum(nbytes_of(d) for _, d in self.fragments)
        return nbytes_of(self.data) if self.data is not None else 0


def nbytes_of(t: torch.Tensor | np.ndarray) -> int:
    """The bytes the reference's ``ndarray.nbytes`` counts for the same data
    (8 a slot for an ``object`` array of exact-sum accumulators)."""
    if isinstance(t, np.ndarray):
        return t.nbytes
    return t.numel() * t.element_size()


@dataclass
class _TxEntry:
    """One unacked reliable send awaiting ack or retransmission."""
    target: int
    payload: Payload
    attempts: int
    next_t: float                      # monotonic deadline for retransmit


class Communicator:
    """Shared mailbox fabric between in-process ranks."""

    def __init__(self, num_nodes: int, *, reliable: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 retransmit_timeout: float = 0.05, max_retries: int = 12,
                 tracer=None, metrics=None):
        self.num_nodes = num_nodes
        self.reliable = reliable
        self.plan = fault_plan
        # observability (DESIGN.md §11): transport stall events mirrored into
        # the unified registry under ``comm.*`` (these are the events the
        # executor's transport-wait attribution points at)
        self.metrics = metrics
        if fault_plan is not None and fault_plan.has_wire_faults() and not reliable:
            raise ValueError("wire faults require the reliable transport "
                             "(reliable=True), else delivery is not guaranteed")
        self.retransmit_timeout = retransmit_timeout
        self.max_retries = max_retries
        self.tracer = tracer
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.pilot_box: list[list[Pilot]] = [[] for _ in range(num_nodes)]
        self.payload_box: list[list[Payload]] = [[] for _ in range(num_nodes)]
        self._listeners: list[list[threading.Event]] = [[] for _ in range(num_nodes)]
        self.bytes_sent = 0
        self.num_messages = 0
        # collective-round accounting (DESIGN.md §9): packed round messages
        # and their real payload bytes, split out from point-to-point pushes;
        # reduce-exchange rounds (transfer ids tagged 3) counted separately
        # so fusion wins are observable next to region-collective traffic
        self.coll_messages = 0
        self.coll_bytes = 0
        self.red_messages = 0
        self.red_bytes = 0
        # reliable-transport state: per-channel next seq, per-sender unacked
        # entries keyed (target, seq), and per-sender inbound ack mailbox of
        # (receiver, seq).  Recovery traffic is accounted separately from the
        # logical counters above so fault-free byte ratios stay exact.
        self._next_seq: dict[tuple[int, int], int] = {}
        self._outstanding: list[dict[tuple[int, int], _TxEntry]] = \
            [{} for _ in range(num_nodes)]
        self.ack_box: list[list[tuple[int, int]]] = [[] for _ in range(num_nodes)]
        self.ctrl_box: list[list[EpochAbort]] = [[] for _ in range(num_nodes)]
        self._delayed: list[tuple[float, int, Payload]] = []
        self.retries = 0
        self.retry_bytes = 0
        self.acks = 0                  # acks posted by receivers
        self.aborts = 0                # EPOCH_ABORT broadcasts
        self.fault_counts = {"drop": 0, "delay": 0, "dup": 0, "pilot_drop": 0}
        # heartbeat bus: each executor loop stamps its slot; watchdogs read
        # peers' staleness to attribute failures (in-process deviation from a
        # real gossip/ping channel — see DESIGN.md §10)
        now = time.monotonic()
        self._beats: list[float] = [now] * num_nodes

    def add_listener(self, node: int, event: threading.Event) -> None:
        """Register an event set whenever traffic arrives for ``node``.

        Lets the executor block on its completion-sink event instead of
        polling the mailbox for inbound pilots/payloads.
        """
        with self._cv:
            self._listeners[node].append(event)

    def _notify(self, node: int) -> None:
        for ev in self._listeners[node]:
            ev.set()

    # -- sender side -------------------------------------------------------
    def post_pilot(self, pilot: Pilot) -> None:
        if (self.plan is not None
                and self.plan.pilot_dropped(pilot.transfer_id, pilot.msg_id)):
            with self._cv:
                self.fault_counts["pilot_drop"] += 1
            if self.metrics is not None:
                self.metrics.counter("comm.pilot_drops")
            if self.tracer is not None:
                self.tracer.instant(f"wire.N{pilot.target}", "pilot_drop",
                                    {"tid": str(pilot.transfer_id)})
            return      # pilots are unacked metadata; the payload carries geometry
        with self._cv:
            self.pilot_box[pilot.target].append(pilot)
            self._cv.notify_all()
            self._notify(pilot.target)

    def isend(self, target: int, payload: Payload) -> None:
        now = time.monotonic()
        with self._cv:
            if self.reliable and payload.source is not None:
                ch = (payload.source, target)
                seq = self._next_seq.get(ch, 0) + 1
                self._next_seq[ch] = seq
                payload.seq = seq
                self._outstanding[payload.source][(target, seq)] = _TxEntry(
                    target=target, payload=payload, attempts=1,
                    next_t=now + self.retransmit_timeout)
            self.bytes_sent += payload.nbytes()
            self.num_messages += 1
            if payload.fragments is not None:
                self.coll_messages += 1
                self.coll_bytes += payload.nbytes()
                tid = payload.transfer_id
                if len(tid) == 4 and tid[2] == 3:
                    self.red_messages += 1
                    self.red_bytes += payload.nbytes()
            self._deliver_locked(target, payload, attempt=1, now=now)
            self._cv.notify_all()
            self._notify(target)

    def _deliver_locked(self, target: int, payload: Payload, attempt: int,
                        now: float) -> None:
        """One delivery attempt through the (possibly faulty) wire."""
        if self.plan is not None:
            fate = self.plan.payload_fate(payload.transfer_id, payload.msg_id,
                                          attempt)
            if fate.duplicate:
                self.fault_counts["dup"] += 1
                self.payload_box[target].append(payload)
            if fate.drop:
                # the retransmit entry stays outstanding; a later attempt
                # re-rolls its fate
                self.fault_counts["drop"] += 1
                if self.metrics is not None:
                    self.metrics.counter("comm.drops")
                if self.tracer is not None:
                    self.tracer.instant(
                        f"wire.N{target}", "drop",
                        {"tid": str(payload.transfer_id), "seq": payload.seq,
                         "attempt": attempt})
                return
            if fate.delay_s > 0.0:
                self.fault_counts["delay"] += 1
                self._delayed.append((now + fate.delay_s, target, payload))
                return
        self.payload_box[target].append(payload)

    def _release_delayed_locked(self, now: float) -> None:
        if not self._delayed:
            return
        keep = []
        for rel, tgt, p in self._delayed:
            if rel <= now:
                self.payload_box[tgt].append(p)
                self._notify(tgt)
            else:
                keep.append((rel, tgt, p))
        self._delayed = keep

    # -- reliable transport --------------------------------------------------
    def has_transport_work(self, node: int) -> bool:
        """Lock-free hint for the executor loop: pump only when needed."""
        return bool(self.ack_box[node] or self._outstanding[node]
                    or self._delayed)

    def pump(self, node: int) -> list[TransportError]:
        """Drain ``node``'s acks, retransmit overdue sends with exponential
        backoff, and mature delayed deliveries.  Returns the sends that
        exhausted their retry budget."""
        now = time.monotonic()
        failures: list[TransportError] = []
        with self._cv:
            self._release_delayed_locked(now)
            acks, self.ack_box[node] = self.ack_box[node], []
            out = self._outstanding[node]
            for key in acks:
                out.pop(key, None)       # dup-acks (from dup deliveries) are fine
            for key, e in list(out.items()):
                if now < e.next_t:
                    continue
                if e.attempts > self.max_retries:
                    del out[key]
                    failures.append(TransportError(
                        f"N{node}->N{e.target}: tid={e.payload.transfer_id} "
                        f"msg={e.payload.msg_id} seq={e.payload.seq} unacked "
                        f"after {e.attempts} attempts"))
                    continue
                e.attempts += 1
                e.next_t = now + self.retransmit_timeout * (1 << (e.attempts - 1))
                self.retries += 1
                self.retry_bytes += e.payload.nbytes()
                if self.metrics is not None:
                    self.metrics.counter("comm.retransmits")
                    self.metrics.counter("comm.retry_bytes",
                                         e.payload.nbytes())
                if self.tracer is not None:
                    self.tracer.instant(
                        f"wire.N{node}", "retransmit",
                        {"tid": str(e.payload.transfer_id), "seq": e.payload.seq,
                         "attempt": e.attempts})
                self._deliver_locked(e.target, e.payload, e.attempts, now)
                self._notify(e.target)
        return failures

    def post_acks(self, receiver: int, acks: list[tuple[int, int]]) -> None:
        """Receiver-side: ack delivered (source, seq) pairs back to senders."""
        if not acks:
            return
        with self._cv:
            for src, seq in acks:
                self.ack_box[src].append((receiver, seq))
                self.acks += 1
            for src in {s for s, _ in acks}:
                self._notify(src)
            self._cv.notify_all()

    def unacked(self, node: int) -> int:
        return len(self._outstanding[node])

    def drop_in_flight(self) -> None:
        """Drop every payload still on the wire: undelivered, delayed or
        kept for retransmission.  After an aborted run these hold snapshots
        in device memory that no receiver will land; the runtime calls this
        once its executors have stopped."""
        with self._cv:
            for box in self.payload_box:
                box.clear()
            for out in self._outstanding:
                out.clear()
            self._delayed.clear()

    def transport_summary(self) -> str:
        pend = {n: len(out) for n, out in enumerate(self._outstanding) if out}
        return (f"unacked sends per node: {pend or 'none'}; "
                f"delayed in flight: {len(self._delayed)}; "
                f"retries={self.retries} acks={self.acks}")

    # -- control plane (failure propagation + heartbeats) ---------------------
    def post_abort(self, abort: EpochAbort) -> None:
        """Broadcast an EPOCH_ABORT poison to every peer of the origin."""
        with self._cv:
            self.aborts += 1
            for n in range(self.num_nodes):
                if n != abort.origin:
                    self.ctrl_box[n].append(abort)
                    self._notify(n)
            self._cv.notify_all()
        if self.metrics is not None:
            self.metrics.counter("comm.aborts")
        if self.tracer is not None:
            self.tracer.instant(f"wire.N{abort.origin}", "epoch_abort",
                                {"cause": abort.cause})

    def poll_ctrl(self, node: int) -> list[EpochAbort]:
        if not self.ctrl_box[node]:
            return []
        with self._cv:
            out, self.ctrl_box[node] = self.ctrl_box[node], []
            return out

    def beat(self, node: int) -> None:
        self._beats[node] = time.monotonic()

    def last_beat(self, node: int) -> float:
        return self._beats[node]

    def stale_peers(self, node: int, timeout: float,
                    now: Optional[float] = None) -> list[int]:
        """Peers of ``node`` whose heartbeat is older than ``timeout``."""
        now = time.monotonic() if now is None else now
        return [p for p in range(self.num_nodes)
                if p != node and now - self._beats[p] > timeout]

    # -- receiver side -----------------------------------------------------
    def poll(self, node: int) -> tuple[list[Pilot], list[Payload]]:
        with self._cv:
            self._release_delayed_locked(time.monotonic())
            pilots, self.pilot_box[node] = self.pilot_box[node], []
            payloads, self.payload_box[node] = self.payload_box[node], []
            return pilots, payloads

    def wait_any(self, node: int, timeout: float = 0.001) -> None:
        with self._cv:
            if not self.pilot_box[node] and not self.payload_box[node]:
                self._cv.wait(timeout)


@dataclass
class _PendingReceive:
    instr: Instruction                 # RECEIVE or SPLIT_RECEIVE
    remaining: Region                  # region still to be covered
    awaits: list[Instruction] = field(default_factory=list)  # AWAIT_RECEIVE children


@dataclass
class _PendingColl:
    """A COLL_RECV: exactly one packed round message from one peer (§9).

    Collective rounds are fully determined by the replicated schedule, so
    the receiver knows the source rank AND the exact fragment keys it will
    land: ``(member, slot)`` pairs for reduction partials, buffer-space
    boxes for region blocks.  Completion requires every expected key.
    """
    instr: Instruction                 # COLL_RECV
    remaining: set                     # fragment keys still outstanding


@dataclass
class _PendingGather:
    """A GATHER_RECEIVE: one fixed-stride slot per expected peer (§2.2).

    Unlike push traffic, gather payloads are addressed by their *source*
    rank — every peer sends the same buffer-space box (a reduction partial),
    and the arbiter lands payload ``p`` at ``arr[p.source]`` of the gather
    staging allocation.  Completion requires one payload from every source.
    """
    instr: Instruction                 # GATHER_RECEIVE
    remaining: set                     # source ranks still outstanding


class _SeenSeqs:
    """Per-channel duplicate filter with watermark compaction.

    Seqs are per (source, target) channel and every seq of the channel is
    eventually delivered here (reliable transport), so the contiguous
    watermark advances and ``extra`` stays bounded by the in-flight window.
    """

    __slots__ = ("contig", "extra")

    def __init__(self) -> None:
        self.contig = 0                 # all seqs <= contig already seen
        self.extra: set[int] = set()

    def admit(self, seq: int) -> bool:
        """True if ``seq`` is new (and mark it seen); False for a duplicate."""
        if seq <= self.contig or seq in self.extra:
            return False
        self.extra.add(seq)
        while self.contig + 1 in self.extra:
            self.contig += 1
            self.extra.discard(self.contig)
        return True


class ReceiveArbiter:
    """Per-node receive-arbitration state machine (paper §4.2).

    Matches inbound pilots/payloads to receive instructions by transfer id,
    writes landed payloads into the destination allocation, and reports
    instruction completions.

    Resilience duties (DESIGN.md §10): every sequence-numbered payload is
    acked on delivery and deduplicated by (source channel, seq) BEFORE any
    matching — landing is idempotent, so retransmits and injected duplicates
    can never corrupt a landed region or touch a freed one-shot staging
    allocation.  Transfer ids tombstoned by :meth:`poison` (an aborted
    epoch) are rejected — and still acked, since the transport did deliver.
    """

    def __init__(self, node: int, comm: Communicator, store):
        self.node = node
        self.comm = comm
        self.store = store                      # allocation id -> tensor
        # CUDA devices written by landing copies since the last ``step``
        self._landed_on: set[torch.device] = set()
        self.pending: dict[tuple, list[_PendingReceive]] = defaultdict(list)
        self.pending_gathers: dict[tuple, list[_PendingGather]] = defaultdict(list)
        self.pending_colls: dict[tuple, list[_PendingColl]] = defaultdict(list)
        self.early_payloads: dict[tuple, list[Payload]] = defaultdict(list)
        self.received: dict[tuple, Region] = defaultdict(Region.empty)
        self._seen: dict[int, _SeenSeqs] = defaultdict(_SeenSeqs)
        self._stale_tids: set[tuple] = set()
        # pilot announcements: tid -> sender ranks, kept while the transfer
        # is in flight so a stuck receive can name the peer that owed data
        self.announced: dict[tuple, set[int]] = defaultdict(set)
        self.dups_suppressed = 0
        self.stale_rejected = 0

    def has_pending(self) -> bool:
        """Whether any receive is in flight (executor gates polling on this)."""
        return (any(self.pending.values())
                or any(self.pending_gathers.values())
                or any(self.pending_colls.values())
                or any(self.early_payloads.values()))

    def begin(self, instr: Instruction) -> None:
        if instr.itype == InstructionType.COLL_RECV:
            pc = _PendingColl(instr=instr, remaining=set(instr.coll_expect))
            self.pending_colls[instr.transfer_id].append(pc)
        elif instr.itype == InstructionType.GATHER_RECEIVE:
            pg = _PendingGather(instr=instr,
                                remaining=set(instr.gather_sources))
            self.pending_gathers[instr.transfer_id].append(pg)
        elif instr.itype in (InstructionType.RECEIVE, InstructionType.SPLIT_RECEIVE):
            pr = _PendingReceive(instr=instr, remaining=instr.recv_region)
            self.pending[instr.transfer_id].append(pr)
        elif instr.itype == InstructionType.AWAIT_RECEIVE:
            for pr in self.pending.get(instr.transfer_id, []):
                if pr.instr is instr.split_parent:
                    pr.awaits.append(instr)
                    return
            # parent may already be fully received
            self.pending[instr.transfer_id].append(
                _PendingReceive(instr=instr.split_parent, remaining=Region.empty(),
                                awaits=[instr]))

    def _put(self, dst, data) -> None:
        """Copy landed data into a store tensor view, or into a view of a
        host reduction scratch (numpy).

        A copy into device memory runs on this (executor) thread's current
        stream, which lane streams do not order against; ``step`` waits for
        it before it reports any receive complete, so the next kernel on a
        lane stream never reads stale rows."""
        if isinstance(dst, np.ndarray):
            dst[...] = data.reshape(dst.shape)
            return
        dst.copy_(data.reshape(dst.shape))
        if dst.is_cuda:
            self._landed_on.add(dst.device)

    def _land(self, pr: _PendingReceive, payload: Payload) -> None:
        alloc = pr.instr.recv_alloc
        arr = self.store[alloc.aid]
        off = alloc.offset_of(payload.box)
        slices = tuple(slice(o, o + s) for o, s in zip(off, payload.box.shape))
        self._put(arr[slices], payload.data)

    def _land_gather(self, pg: _PendingGather, payload: Payload) -> None:
        """Land a reduction partial at its source rank's fixed-stride slot."""
        arr = self.store[pg.instr.recv_alloc.aid]
        self._put(arr[payload.source], payload.data)

    def _land_coll(self, pc: _PendingColl, payload: Payload) -> None:
        """Land every fragment of one packed collective round message."""
        instr = pc.instr
        if instr.coll_land:
            # allreduce slot-range fragments: the landing map names the
            # target allocation and flat range per expected key
            lmap = {f.key: f for f in instr.coll_land}
            for key, data in payload.fragments:
                f = lmap.get(key)
                if f is None:
                    continue
                lo, hi = f.srange
                self._put(self.store[f.alloc.aid][lo:hi], data)
                pc.remaining.discard(key)
            return
        for key, data in payload.fragments:
            if isinstance(key, Box):    # buffer-space region fragment
                alloc = instr.coll_allocs[0]
                arr = self.store[alloc.aid]
                off = alloc.offset_of(key)
                slices = tuple(slice(o, o + s)
                               for o, s in zip(off, key.shape))
                self._put(arr[slices], data)
            else:                       # (member, slot) partial fragment
                member, slot = key
                arr = self.store[instr.coll_allocs[member].aid]
                self._put(arr[slot], data)
            pc.remaining.discard(key)

    def poison(self, reason: str = "epoch aborted") -> int:
        """Abort every in-flight receive: tombstone their transfer ids and
        drop buffered traffic.  Late/retransmitted payloads for a poisoned
        tid are counted in ``stale_rejected`` and never land (the epoch they
        belonged to is gone; its allocations may be too).  Returns the number
        of tombstoned transfer ids."""
        tids: set[tuple] = set()
        for m in (self.pending, self.pending_gathers, self.pending_colls,
                  self.early_payloads):
            tids.update(m.keys())
            m.clear()
        self._stale_tids.update(tids)
        self.received.clear()
        self.announced.clear()
        return len(tids)

    def pending_report(self) -> str:
        """One-line stall diagnosis: what is owed, and by whom (per pilots)."""
        parts = []
        for kind, m in (("recv", self.pending), ("gather", self.pending_gathers),
                        ("coll", self.pending_colls)):
            for tid, entries in m.items():
                if not entries:
                    continue
                src = sorted(self.announced.get(tid, ()))
                owed = f" announced by N{src}" if src else " (no pilot seen)"
                parts.append(f"{kind} tid={tid}{owed}")
        return "; ".join(parts) if parts else "no receives pending"

    def _admit(self, payloads: list[Payload]) -> list[Payload]:
        """Transport ingress: ack every sequenced copy, suppress duplicates,
        reject tombstoned transfer ids."""
        acks: list[tuple[int, int]] = []
        fresh: list[Payload] = []
        for p in payloads:
            if p.seq is not None:
                acks.append((p.source, p.seq))
                if not self._seen[p.source].admit(p.seq):
                    self.dups_suppressed += 1
                    continue
            if p.transfer_id in self._stale_tids:
                self.stale_rejected += 1
                continue
            fresh.append(p)
        if acks:
            self.comm.post_acks(self.node, acks)
        return fresh

    def step(self, completions: list[Instruction]) -> None:
        """Drain mailboxes; append completed instructions to ``completions``."""
        pilots, payloads = self.comm.poll(self.node)
        # pilots tell us geometry early; with the mailbox transport the
        # payload itself carries geometry, so pilots feed accounting and
        # stall attribution (who owes a stuck receive data)
        for pl in pilots:
            if pl.transfer_id not in self._stale_tids:
                self.announced[pl.transfer_id].add(pl.source)
        for p in self._admit(payloads):
            self.early_payloads[p.transfer_id].append(p)
        # collective rounds: match by (round-tagged transfer id, source);
        # one packed message lands all expected fragments at once
        for tid, plist in list(self.early_payloads.items()):
            pcs = self.pending_colls.get(tid)
            if not pcs:
                continue
            still: list[Payload] = []
            for payload in plist:
                landed = False
                if payload.fragments is not None:
                    for pc in pcs:
                        if payload.source == pc.instr.coll_source:
                            self._land_coll(pc, payload)
                            landed = True
                            break
                if not landed:
                    still.append(payload)
            self.early_payloads[tid] = still
        for tid, pcs in list(self.pending_colls.items()):
            done = [pc for pc in pcs
                    if not pc.remaining and pc.instr.state == "issued"]
            for pc in done:
                completions.append(pc.instr)
                pcs.remove(pc)
            if not pcs:
                del self.pending_colls[tid]
                self.announced.pop(tid, None)
        # gather receives: match by (transfer id, source), complete when every
        # expected peer landed exactly once
        for tid, plist in list(self.early_payloads.items()):
            pgs = self.pending_gathers.get(tid)
            if not pgs:
                continue
            still: list[Payload] = []
            for payload in plist:
                landed = False
                for pg in pgs:
                    if payload.source in pg.remaining:
                        self._land_gather(pg, payload)
                        pg.remaining.discard(payload.source)
                        landed = True
                        break
                if not landed:
                    still.append(payload)
            self.early_payloads[tid] = still
        for tid, pgs in list(self.pending_gathers.items()):
            done = [pg for pg in pgs
                    if not pg.remaining and pg.instr.state == "issued"]
            for pg in done:
                completions.append(pg.instr)
                pgs.remove(pg)
            if not pgs:
                del self.pending_gathers[tid]
                self.announced.pop(tid, None)
                self.received.pop(tid, None)
        for tid, plist in list(self.early_payloads.items()):
            prs = self.pending.get(tid, [])
            if not prs:
                continue
            still: list[Payload] = []
            for payload in plist:
                landed = False
                for pr in prs:
                    if pr.remaining.is_empty():
                        continue
                    inter = pr.remaining.intersect(Region.from_box(payload.box))
                    if inter.is_empty():
                        continue
                    self._land(pr, payload)
                    pr.remaining = pr.remaining.difference(Region.from_box(payload.box))
                    self.received[tid] = self.received[tid].union(Region.from_box(payload.box))
                    landed = True
                    break
                if not landed:
                    still.append(payload)
            self.early_payloads[tid] = still
        # completion checks
        for tid, prs in list(self.pending.items()):
            done_prs = []
            for pr in prs:
                if pr.remaining.is_empty() and pr.instr.state == "issued":
                    if pr.instr.itype == InstructionType.RECEIVE:
                        completions.append(pr.instr)
                        done_prs.append(pr)
                    elif pr.instr.itype == InstructionType.SPLIT_RECEIVE:
                        completions.append(pr.instr)
                        # keep entry for awaits
                # await-receive: complete when its subregion is covered.  A
                # parent in state "done" was fully received, which covers any
                # await — this keeps late-registered awaits correct even
                # after the coverage map below has been dropped.
                cov = self.received.get(tid)
                for aw in list(pr.awaits):
                    if aw.state == "issued" and (
                            (cov is not None and cov.contains(aw.recv_region))
                            or (pr.instr is not None
                                and pr.instr.state == "done")):
                        completions.append(aw)
                        pr.awaits.remove(aw)
                if (pr.remaining.is_empty() and not pr.awaits
                        and pr.instr.state == "done"):
                    done_prs.append(pr)
            for pr in done_prs:
                if pr in prs:
                    prs.remove(pr)
            if not prs:
                self.announced.pop(tid, None)
                # drop the coverage map with the last receive: transfer ids
                # are never reused, so nothing can consult it again, and a
                # long-running serving process must not accumulate one
                # Region per transfer forever
                self.received.pop(tid, None)
        # a receive completes only once its landing copies have finished
        for dev in self._landed_on:
            torch.cuda.current_stream(dev).synchronize()
        self._landed_on.clear()
