# Copied from src/repro/core/instruction_graph.py.
"""Instruction graph (IDAG) generation — the paper's core contribution (§3).

Compiles each node's command stream into micro-operations: ``alloc / copy /
free / spill / reload / send / receive / split-receive / await-receive /
device-kernel / host-task / horizon / epoch``.  Key mechanisms implemented
faithfully:

* hierarchical work assignment — the command chunk is split a second time
  over the node's local devices (§3.1);
* virtualized buffers with multiple disjoint backing allocations per
  (buffer, memory); every accessor must be backed by one *contiguous*
  allocation, triggering alloc→copy→free resize chains when access patterns
  grow (§3.2, fig. 3);
* local coherence with producer- and consumer-split copies (§3.3);
* outbound transfers: producer-split sends + pilot messages; inbound:
  receive vs split-receive/await-receive under the union-only constraint of
  await-push commands (§3.4);
* horizon/epoch instructions for pruning and synchronization (§3.5);
* allocation widening driven by the scheduler lookahead (§4.3).

The allocation *lifecycle* — backing allocations, coherence, widening,
byte budgets and spill/reload under pressure — lives in
:class:`repro.core.memory.MemoryManager` (DESIGN.md §8); this generator is
a pure consumer that requests regions and receives placements.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from typing import Optional

from .allocation import (PINNED_HOST, USER_HOST, device_memory,  # noqa: F401
                         is_device_memory, queue_for_mem)
from .buffer import AccessMode, VirtualBuffer
from .collective import (allgather_schedule, reduce_scatter_schedule,
                         schedule_for, shard_bounds)
from .command_graph import Command, CommandType
from .instructions import (AccessorBinding, CollFragment,  # noqa: F401
                           EpochAbort, Instruction, InstructionType, Pilot,
                           ReductionBinding)
from .memory import MemoryManager
from .region import Box, Region, split_box
from .task_graph import DepKind, TaskType


class IdagGenerator:
    """Per-node instruction graph generator."""

    def __init__(self, node: int, num_devices: int, *, d2d: bool = True,
                 alloc_hints: Optional[dict] = None, retire: bool = False,
                 budgets: Optional[dict[int, int]] = None, metrics=None,
                 namespace: Optional[str] = None,
                 buffer_owner: Optional[dict[int, str]] = None,
                 renaming: bool = False):
        self.node = node
        self.num_devices = num_devices
        # ``retire=True`` (used by the runtime) trims ``instructions`` down to
        # the window since the last horizon/epoch, so generator memory stays
        # bounded on long runs; ``emitted_count`` keeps the lifetime total.
        self.retire = retire
        self.instructions: list[Instruction] = []
        self.emitted_count = 0
        self.alloc_count = 0
        self._batch: list[Instruction] = []
        self._frontier_pos = 0          # index of the last sync instruction
        self.pilots: list[Pilot] = []
        self.warnings: list[str] = []
        # in-flight reduction state, keyed by reduction transfer id:
        # device partial scratches (+ producing kernels), the node partial
        # (+ its LOCAL_REDUCE) and the partial-broadcast sends
        self._red_state: dict[tuple, dict] = {}
        # collective-mode reduction state (DESIGN.md §9), keyed by rtid:
        # the per-member staging (slot s = rank s's partial), the member's
        # LOCAL_REDUCE and the fusion group's shared exchange instructions
        self._coll_red: dict[tuple, dict] = {}
        self._msg_ids = itertools.count(node * 1_000_000)
        self._last_horizon: Optional[Instruction] = None
        self._last_epoch: Optional[Instruction] = None
        # the memory layer: allocation lifecycle, coherence, budgets,
        # spill/reload (DESIGN.md §8); widening hints double as reservations
        self.mem = MemoryManager(self, d2d=d2d, budgets=budgets,
                                 hints=alloc_hints, metrics=metrics,
                                 namespace=namespace,
                                 buffer_owner=buffer_owner,
                                 renaming=renaming)
        self._init_epoch = self._emit(Instruction(
            InstructionType.EPOCH, node=node, queue=("host",), name="init"))
        self._last_epoch = self._init_epoch
        self.mem.init_anchor = self._init_epoch
        # the bootstrap epoch is consumed via ``instructions`` by the
        # runtime; leave no open batch behind (capture_batch relies on it)
        self._batch = []

    # -- small helpers ---------------------------------------------------
    @contextmanager
    def capture_batch(self, out: list):
        """Collect EVERY instruction emitted inside the scope into ``out``.

        For callers outside :meth:`compile` (e.g. the memory layer's reload
        prefetch) that must schedule side-effect emissions — allocs, frees,
        cascade spills — not just the instructions a helper returns.  Must
        not be entered while a ``compile`` batch is open.
        """
        assert not self._batch, "capture_batch inside an open compile batch"
        self._batch = []
        try:
            yield
        finally:
            out.extend(self._batch)
            self._batch = []

    def _emit(self, instr: Instruction) -> Instruction:
        self.instructions.append(instr)
        self.emitted_count += 1
        if instr.itype == InstructionType.ALLOC:
            self.alloc_count += 1
        self._batch.append(instr)
        return instr

    def _register(self, buf: VirtualBuffer) -> None:
        self.mem.register_buffer(buf)

    # -- memory-layer pass-throughs (compat + convenience) -----------------
    @property
    def _allocs(self) -> dict:
        """Live-allocation map — owned by the MemoryManager; read-only
        compatibility view for tests and diagnostics."""
        return self.mem.allocations

    @property
    def _mem(self) -> dict:
        """Per-(buffer, memory) producer/reader state — owned by the
        MemoryManager; read-only compatibility view."""
        return self.mem.mem

    @property
    def alloc_hints(self) -> dict:
        return self.mem.hints

    @alloc_hints.setter
    def alloc_hints(self, hints: dict) -> None:
        self.mem.reserve(hints)

    def would_allocate_box(self, bid: int, mid: int, box: Box) -> bool:
        return self.mem.would_allocate_box(bid, mid, box)

    def ensure_allocation(self, buf: VirtualBuffer, mid: int, box: Box):
        """Placement request — delegates to the memory layer (§3.2)."""
        return self.mem.ensure(buf, mid, box)

    def make_coherent(self, buf: VirtualBuffer, mid: int,
                      region: Region) -> list[Instruction]:
        """Residency request — delegates to the memory layer (§3.3)."""
        return self.mem.make_coherent(buf, mid, region)

    # -- command compilation ------------------------------------------------
    def compile(self, cmd: Command) -> list[Instruction]:
        self._batch = []
        # pin scope: every allocation this command touches stays resident
        # until the command is fully lowered (eviction must never drop the
        # working set out from under a half-compiled kernel)
        with self.mem.pin_scope():
            if cmd.ctype == CommandType.EXECUTION:
                self._compile_execution(cmd)
            elif cmd.ctype == CommandType.PUSH:
                self._compile_push(cmd)
            elif cmd.ctype == CommandType.AWAIT_PUSH:
                self._compile_await_push(cmd)
            elif cmd.ctype == CommandType.REDUCE_PARTIAL:
                self._compile_reduce_partial(cmd)
            elif cmd.ctype == CommandType.REDUCE_GLOBAL:
                self._compile_reduce_global(cmd)
            elif cmd.ctype == CommandType.COLL_ALLREDUCE:
                self._compile_allreduce(cmd)
            elif cmd.ctype in (CommandType.COLL_ALLGATHER,
                               CommandType.COLL_BROADCAST,
                               CommandType.COLL_SCATTER):
                if cmd.reduction is not None:
                    self._compile_reduce_exchange(cmd)
                else:
                    self._compile_collective(cmd)
            elif cmd.ctype == CommandType.HORIZON:
                self._compile_sync(cmd, InstructionType.HORIZON)
            elif cmd.ctype == CommandType.EPOCH:
                self._compile_sync(cmd, InstructionType.EPOCH)
        out, self._batch = self._batch, []
        return out

    def would_allocate(self, cmd: Command) -> bool:
        """Cheap query used by the lookahead scheduler (§4.3)."""
        reqs = self.allocation_requirements(cmd)
        return any(self.mem.would_allocate_box(bid, mid, box)
                   for (bid, mid), region in reqs.items()
                   for box in [region.bounding_box()])

    def allocation_requirements(self, cmd: Command) -> dict[tuple[int, int], Region]:
        """(bid, mid) -> contiguous requirement regions for this command."""
        reqs: dict[tuple[int, int], Region] = {}

        def add(bid: int, mid: int, box: Box) -> None:
            key = (bid, mid)
            reqs[key] = reqs.get(key, Region.empty()).union(Region.from_box(box))

        if cmd.ctype == CommandType.EXECUTION and cmd.task is not None:
            is_host = cmd.task.ttype == TaskType.HOST
            chunks = ([cmd.chunk] if is_host else
                      split_box(cmd.chunk, self.num_devices,
                                dims=cmd.task.split_dims,
                                granularity=cmd.task.granularity))
            for d, ch in enumerate(chunks):
                mid = PINNED_HOST if is_host else device_memory(d)
                for acc in cmd.task.accessors:
                    reg = acc.mapped_region(ch)
                    if not reg.is_empty():
                        add(acc.buffer.bid, mid, reg.bounding_box())
        elif cmd.ctype == CommandType.PUSH:
            add(cmd.buffer.bid, PINNED_HOST, cmd.region.bounding_box())
        elif cmd.ctype == CommandType.AWAIT_PUSH:
            add(cmd.buffer.bid, PINNED_HOST, cmd.region.bounding_box())
        elif cmd.ctype == CommandType.REDUCE_GLOBAL:
            # the combined result lands in the buffer's host backing; the
            # partial/gather scratches are unhinted one-shot allocations
            add(cmd.buffer.bid, PINNED_HOST, cmd.buffer.full_box)
        elif cmd.ctype in (CommandType.COLL_ALLGATHER,
                           CommandType.COLL_BROADCAST,
                           CommandType.COLL_SCATTER,
                           CommandType.COLL_ALLREDUCE):
            # region collectives stage through the buffer's pinned-host
            # backing; reduction exchanges use unhinted one-shot staging
            if cmd.reduction is None and cmd.region is not None \
                    and not cmd.region.is_empty():
                add(cmd.buffer.bid, PINNED_HOST, cmd.region.bounding_box())
        return reqs

    # -- execution commands (§3.1, §3.3) -------------------------------------
    def _compile_execution(self, cmd: Command) -> None:
        task = cmd.task
        is_host = task.ttype == TaskType.HOST
        chunks = ([cmd.chunk] if is_host else
                  split_box(cmd.chunk, self.num_devices,
                            dims=task.split_dims, granularity=task.granularity))
        # overlapping-write detection between local devices (paper §4.4)
        if len(chunks) > 1:
            for acc in task.accessors:
                if not acc.mode.is_producer:
                    continue
                for i in range(len(chunks)):
                    for j in range(i + 1, len(chunks)):
                        ri = acc.mapped_region(chunks[i])
                        rj = acc.mapped_region(chunks[j])
                        if ri.overlaps(rj):
                            self.warnings.append(
                                f"overlapping write to {acc.buffer.name} by "
                                f"devices D{i} and D{j} in task {task.name}")
        for d, ch in enumerate(chunks):
            mid = PINNED_HOST if is_host else device_memory(d)
            bindings: list[AccessorBinding] = []
            deps: list[Instruction] = []
            # phase 1: settle ALL allocations first — a later accessor's
            # resize may free the allocation an earlier accessor would have
            # bound to (found by hypothesis, tests/test_lookahead_property)
            for acc in task.accessors:
                self._register(acc.buffer)
                reg = acc.mapped_region(ch)
                if not reg.is_empty():
                    self.mem.ensure(acc.buffer, mid, reg.bounding_box())
            # phase 2: coherence + bindings against the settled allocations
            for acc in task.accessors:
                buf = acc.buffer
                reg = acc.mapped_region(ch)
                if reg.is_empty():
                    continue
                # renaming (DESIGN.md §13): a pure overwrite — discard-write
                # accessor, and no accessor of the same buffer reads in this
                # task — rebinds the version to a fresh physical so the
                # write carries no WAR/WAW edges against prior readers
                if (acc.mode == AccessMode.WRITE
                        and not any(a2 is not acc
                                    and a2.buffer.bid == buf.bid
                                    and a2.mode.is_consumer
                                    for a2 in task.accessors)):
                    self.mem.rename_for_write(buf, mid, reg)
                alloc = self.mem.live(buf.bid, mid, reg.bounding_box())
                if acc.mode.is_consumer:
                    deps.extend(self.mem.make_coherent(buf, mid, reg))
                bindings.append(AccessorBinding(acc, alloc, reg))
            # reduction outputs: one identity-filled accumulator scratch per
            # (device chunk, reduction) — never the buffer's own allocation,
            # since every chunk "writes" the same full-buffer region
            red_bindings: list[ReductionBinding] = []
            fills: list[Instruction] = []
            for red in task.reductions:
                buf = red.buffer
                self._register(buf)
                scratch, fill = self._emit_reduction_scratch(red, mid)
                red_bindings.append(ReductionBinding(red, scratch))
                fills.append(fill)
            itype = InstructionType.HOST_TASK if is_host else InstructionType.DEVICE_KERNEL
            qd = ("host",) if is_host else ("device", d)
            instr = Instruction(
                itype, node=self.node, queue=qd, kernel_fn=task.kernel_fn,
                chunk=ch, bindings=tuple(bindings),
                red_bindings=tuple(red_bindings),
                device=None if is_host else d, name=task.name, command=cmd)
            for f in fills:
                instr.add_dependency(f, DepKind.TRUE)
            for b in bindings:
                ai = b.allocation.alloc_instr
                if ai is not None:
                    instr.add_dependency(ai, DepKind.TRUE)
                ms = self.mem.state(b.accessor.buffer.bid, mid)
                if b.accessor.mode.is_consumer:
                    for sub, producer in ms.producers.query(b.region):
                        instr.add_dependency(producer, DepKind.TRUE)
                    ms.readers.append((b.region, instr))
                if b.accessor.mode.is_producer:
                    for r, reader in ms.readers:
                        if reader is not instr and r.overlaps(b.region):
                            instr.add_dependency(reader, DepKind.ANTI)
                    for sub, w in ms.producers.query(b.region):
                        instr.add_dependency(w, DepKind.OUTPUT)
                    # first writer of a recycled physical: order behind the
                    # retired version's outstanding users (DESIGN.md §13)
                    for h in self.mem.take_hazards(b.allocation):
                        instr.add_dependency(h, DepKind.ANTI)
            if self._last_horizon is not None:
                instr.add_dependency(self._last_horizon, DepKind.SYNC)
            elif not instr.dependencies and self._last_epoch is not None:
                instr.add_dependency(self._last_epoch, DepKind.SYNC)
            self._emit(instr)
            for rb in red_bindings:
                rtid = (task.tid, rb.reduction.buffer.bid, 1)
                st = self._red_state.setdefault(
                    rtid, {"device": [], "partial": None, "sends": []})
                st["device"].append((rb.allocation, instr))
            # post-emit state updates: writes establish new producers/coherence
            for b in bindings:
                if b.accessor.mode.is_producer:
                    bid = b.accessor.buffer.bid
                    ms = self.mem.state(bid, mid)
                    ms.producers.update(b.region, instr)
                    ms.readers = [(r, t) for r, t in ms.readers
                                  if t is instr or not r.difference(b.region).is_empty()]
                    self.mem.coherence[bid].update(b.region, frozenset([mid]))
                    self.mem.note_write(bid, b.region)

    # -- outbound transfers (§3.4) -------------------------------------------
    def _compile_push(self, cmd: Command) -> None:
        buf = cmd.buffer
        self._register(buf)
        # stage into pinned host memory, then one send per producer-rect
        self.mem.make_coherent(buf, PINNED_HOST, cmd.region)
        ms = self.mem.state(buf.bid, PINNED_HOST)
        for alloc in self.mem.allocations.get((buf.bid, PINNED_HOST), []):
            if not alloc.live:
                continue
            part = cmd.region.intersect_box(alloc.box)
            for psub, producer in ms.producers.query(part):
                for b in psub.boxes:  # producer split
                    msg_id = next(self._msg_ids)
                    send = Instruction(
                        InstructionType.SEND, node=self.node, queue=("comm",),
                        dest=cmd.target, msg_id=msg_id, send_box=b,
                        recv_alloc=alloc, transfer_id=cmd.transfer_id,
                        name=f"send {buf.name} {b} ->N{cmd.target}", command=cmd)
                    send.add_dependency(producer, DepKind.TRUE)
                    ai = alloc.alloc_instr
                    if ai is not None:
                        send.add_dependency(ai, DepKind.TRUE)
                    if self._last_horizon is not None:
                        send.add_dependency(self._last_horizon, DepKind.SYNC)
                    self._emit(send)
                    ms.readers.append((Region.from_box(b), send))
                    self.pilots.append(Pilot(source=self.node, target=cmd.target,
                                             transfer_id=cmd.transfer_id, box=b,
                                             msg_id=msg_id))

    # -- inbound transfers (§3.4) ----------------------------------------------
    def _compile_await_push(self, cmd: Command) -> None:
        buf = cmd.buffer
        self._register(buf)
        # must be able to receive the whole union contiguously (case b)
        alloc = self.mem.ensure(buf, PINNED_HOST, cmd.region.bounding_box())
        ms = self.mem.state(buf.bid, PINNED_HOST)

        consumer_regions = self._consumer_split_regions(cmd)
        anti_deps: list[Instruction] = []
        for r, reader in ms.readers:
            if r.overlaps(cmd.region):
                anti_deps.append(reader)
        for sub, w in ms.producers.query(cmd.region):
            anti_deps.append(w)

        def wire(instr: Instruction) -> Instruction:
            ai = alloc.alloc_instr
            if ai is not None:
                instr.add_dependency(ai, DepKind.TRUE)
            for a in anti_deps:
                instr.add_dependency(a, DepKind.ANTI)
            if self._last_horizon is not None:
                instr.add_dependency(self._last_horizon, DepKind.SYNC)
            return self._emit(instr)

        if len(consumer_regions) <= 1:
            recv = wire(Instruction(
                InstructionType.RECEIVE, node=self.node, queue=("comm",),
                transfer_id=cmd.transfer_id, recv_region=cmd.region,
                recv_alloc=alloc, name=f"recv {buf.name} {cmd.region}", command=cmd))
            ms.producers.update(cmd.region, recv)
        else:
            split = wire(Instruction(
                InstructionType.SPLIT_RECEIVE, node=self.node, queue=("comm",),
                transfer_id=cmd.transfer_id, recv_region=cmd.region,
                recv_alloc=alloc, name=f"split-recv {buf.name} {cmd.region}",
                command=cmd))
            for creg in consumer_regions:
                aw = self._emit(Instruction(
                    InstructionType.AWAIT_RECEIVE, node=self.node, queue=("comm",),
                    transfer_id=cmd.transfer_id, recv_region=creg,
                    recv_alloc=alloc, split_parent=split,
                    name=f"await-recv {buf.name} {creg}", command=cmd))
                aw.add_dependency(split, DepKind.TRUE)
                ms.producers.update(creg, aw)
        self.mem.coherence[buf.bid].update(cmd.region, frozenset([PINNED_HOST]))
        # fresh remote data supersedes anything spilled from this region
        self.mem.note_write(buf.bid, cmd.region)

    def _consumer_split_regions(self, cmd: Command) -> list[Region]:
        """Subregions per local consumer (device chunk) of an await-push."""
        regions: list[Region] = []
        for dep in cmd.dependents:
            if dep.ctype != CommandType.EXECUTION or dep.task is None:
                continue
            chunks = split_box(dep.chunk, self.num_devices,
                               dims=dep.task.split_dims,
                               granularity=dep.task.granularity)
            for ch in chunks:
                for acc in dep.task.accessors:
                    if acc.buffer.bid != cmd.buffer.bid or not acc.mode.is_consumer:
                        continue
                    part = acc.mapped_region(ch).intersect(cmd.region)
                    if not part.is_empty():
                        regions.append(part)
        # dedupe; if all consumers want the whole region, no split (§3.4)
        uniq: list[Region] = []
        for r in regions:
            if not any(r == u for u in uniq):
                uniq.append(r)
        if len(uniq) <= 1 or all(u.contains(cmd.region) for u in uniq):
            return uniq[:1]
        return uniq

    # -- reductions -----------------------------------------------------------
    def _emit_reduction_scratch(self, red,
                                mid: int) -> tuple:
        """Allocate + identity-fill one accumulator scratch in ``mid``."""
        buf = red.buffer
        scratch = self.mem.scratch(
            mid, buf.full_box, red.op.acc_dtype(buf.dtype),
            f"alloc red-partial {buf.name} M{mid}")
        fill = self._emit(Instruction(
            InstructionType.FILL_IDENTITY, node=self.node,
            queue=queue_for_mem(mid), allocation=scratch, reduction=red,
            name=f"fill-identity {buf.name} ({red.op.name}) M{mid}"))
        fill.add_dependency(scratch.alloc_instr, DepKind.TRUE)
        return scratch, fill

    def _red_staging(self, rtid: tuple, red, group_size: int) -> dict:
        """Collective-mode staging for one reduction component: slot ``s``
        holds rank ``s``'s partial (own slot written by LOCAL_REDUCE, peer
        slots landed by the exchange rounds)."""
        cst = self._coll_red.setdefault(rtid, {})
        if "staging" not in cst:
            buf = red.buffer
            gbox = Box((0,) * (buf.full_box.rank + 1),
                       (group_size,) + buf.shape)
            cst["staging"] = self.mem.scratch(
                PINNED_HOST, gbox, red.op.acc_dtype(buf.dtype),
                f"alloc red-staging {buf.name}")
        return cst

    def _red_staging_flat(self, rtid: tuple, red) -> dict:
        """Allreduce-mode staging: ONE flat accumulator over the member's
        slot space (flattened buffer elements).  LOCAL_REDUCE writes the
        whole node partial into it; reduce-scatter rounds fold incoming
        slot-range fragments in place; allgather rounds land the final
        folded shards of the other owners (DESIGN.md §9)."""
        cst = self._coll_red.setdefault(rtid, {})
        if "staging" not in cst:
            buf = red.buffer
            cst["staging"] = self.mem.scratch(
                PINNED_HOST, Box((0,), (buf.full_box.volume(),)),
                red.op.acc_dtype(buf.dtype), f"alloc red-acc {buf.name}")
            cst["mode"] = "allreduce"
            cst["tail"] = None          # fold chain: LOCAL_REDUCE, rs folds
        return cst

    def _compile_reduce_partial(self, cmd: Command) -> None:
        """Fold device partials into one node partial, broadcast it (§2.2).

        Collective mode (DESIGN.md §9): the node partial is written straight
        into this rank's slot of the staging allocation — the exchange
        rounds (emitted by the fused COLL_ALLGATHER) read it from there, so
        there is no separate partial scratch and no per-peer broadcast.
        """
        if cmd.collective:
            red, buf = cmd.reduction, cmd.buffer
            st = self._red_state[cmd.transfer_id]
            device_parts = st["device"]
            if cmd.allreduce:
                # flat slot-space accumulator: the whole node partial lands
                # in it, reduce-scatter folds happen in place
                cst = self._red_staging_flat(cmd.transfer_id, red)
                staging = cst["staging"]
                dst_slot = None
                tag = "->acc"
            else:
                cst = self._red_staging(cmd.transfer_id, red,
                                        max(cmd.coll_group) + 1)
                staging = cst["staging"]
                dst_slot = self.node
                tag = f"->slot{self.node}"
            lr = Instruction(
                InstructionType.LOCAL_REDUCE, node=self.node, queue=("host",),
                reduction=red, reduce_srcs=tuple(a for a, _ in device_parts),
                dst_alloc=staging, dst_slot=dst_slot, command=cmd,
                name=f"local-reduce {buf.name} ({red.op.name}) {tag}")
            lr.add_dependency(staging.alloc_instr, DepKind.TRUE)
            for alloc, producer in device_parts:
                lr.add_dependency(producer, DepKind.TRUE)
                if alloc.alloc_instr is not None:
                    lr.add_dependency(alloc.alloc_instr, DepKind.TRUE)
            self._emit(lr)
            cst["local"] = lr
            if cmd.allreduce:
                cst["tail"] = lr
            for alloc, _ in device_parts:
                self.mem.free_scratch(alloc, [lr])
            return
        red, buf = cmd.reduction, cmd.buffer
        st = self._red_state[cmd.transfer_id]
        device_parts: list[tuple] = st["device"]
        partial = self.mem.scratch(
            PINNED_HOST, buf.full_box, red.op.acc_dtype(buf.dtype),
            f"alloc red-node-partial {buf.name}")
        lr = Instruction(
            InstructionType.LOCAL_REDUCE, node=self.node, queue=("host",),
            reduction=red, reduce_srcs=tuple(a for a, _ in device_parts),
            dst_alloc=partial, command=cmd,
            name=f"local-reduce {buf.name} ({red.op.name})")
        lr.add_dependency(partial.alloc_instr, DepKind.TRUE)
        for alloc, producer in device_parts:
            lr.add_dependency(producer, DepKind.TRUE)
            if alloc.alloc_instr is not None:
                lr.add_dependency(alloc.alloc_instr, DepKind.TRUE)
        self._emit(lr)
        st["partial"] = (partial, lr)
        for alloc, _ in device_parts:
            self.mem.free_scratch(alloc, [lr])
        # broadcast the node partial to every other rank; the receiver's
        # GATHER_RECEIVE matches this traffic by its 3-tuple transfer id
        # and lands each payload at its SOURCE rank's slot
        for target in cmd.targets:
            msg_id = next(self._msg_ids)
            send = Instruction(
                InstructionType.SEND, node=self.node, queue=("comm",),
                dest=target, msg_id=msg_id, send_box=buf.full_box,
                recv_alloc=partial, transfer_id=cmd.transfer_id, command=cmd,
                name=f"send red-partial {buf.name} ->N{target}")
            send.add_dependency(lr, DepKind.TRUE)
            if self._last_horizon is not None:
                send.add_dependency(self._last_horizon, DepKind.SYNC)
            self._emit(send)
            st["sends"].append(send)
            self.pilots.append(Pilot(source=self.node, target=target,
                                     transfer_id=cmd.transfer_id,
                                     box=buf.full_box, msg_id=msg_id,
                                     gather=True))

    def _compile_reduce_exchange(self, cmd: Command) -> None:
        """Lower the (fused) reduction allgather into O(log N) rounds.

        One COLL_SEND per (round, message) carries one *packed* payload:
        for every member component of the fusion group, the partial slots
        named by the dissemination schedule.  Each round is independently
        schedulable (a round-k send depends only on the previous rounds'
        landings of the slots it forwards), so rounds of different
        collectives interleave in the out-of-order engine.
        """
        members = cmd.coll_members                 # ((rtid, Reduction), ...)
        group = cmd.coll_group
        gsize = max(group) + 1
        stagings = []
        for rtid, red in members:
            cst = self._red_staging(rtid, red, gsize)
            stagings.append(cst["staging"])
        rounds = schedule_for("allgather", group,
                              contributors=cmd.participants)
        lane = f"N{self.node}.coll.t{cmd.transfer_id[0]}b{cmd.transfer_id[1]}"
        slot_src: dict[int, Instruction] = {}      # slot rank -> landing recv
        recvs: list[Instruction] = []
        sends: list[Instruction] = []
        for k, msgs in enumerate(rounds):
            rtid_k = cmd.transfer_id + (k,)
            for m in msgs:
                if m.dst == self.node:
                    expect = tuple((mi, b) for mi in range(len(members))
                                   for b in m.blocks)
                    rc = Instruction(
                        InstructionType.COLL_RECV, node=self.node,
                        queue=("comm",), transfer_id=rtid_k,
                        coll_source=m.src, coll_allocs=tuple(stagings),
                        coll_expect=expect, command=cmd, trace_lane=lane,
                        name=f"coll-recv r{k} {cmd.buffer.name} <-N{m.src}")
                    for a in stagings:
                        rc.add_dependency(a.alloc_instr, DepKind.TRUE)
                    if self._last_horizon is not None:
                        rc.add_dependency(self._last_horizon, DepKind.SYNC)
                    self._emit(rc)
                    recvs.append(rc)
                    for b in m.blocks:
                        slot_src[b] = rc
                if m.src == self.node:
                    frags = tuple(CollFragment(key=(mi, b),
                                               alloc=stagings[mi], slot=b)
                                  for mi in range(len(members))
                                  for b in m.blocks)
                    msg_id = next(self._msg_ids)
                    sd = Instruction(
                        InstructionType.COLL_SEND, node=self.node,
                        queue=("comm",), dest=m.dst, msg_id=msg_id,
                        transfer_id=rtid_k, coll_frags=frags, command=cmd,
                        trace_lane=lane,
                        name=f"coll-send r{k} {cmd.buffer.name} ->N{m.dst}")
                    for a in stagings:
                        sd.add_dependency(a.alloc_instr, DepKind.TRUE)
                    for b in m.blocks:
                        if b == self.node:
                            for rtid, _ in members:
                                lr = self._coll_red[rtid].get("local")
                                if lr is not None:
                                    sd.add_dependency(lr, DepKind.TRUE)
                        else:
                            rc = slot_src.get(b)
                            if rc is not None:
                                sd.add_dependency(rc, DepKind.TRUE)
                    if self._last_horizon is not None:
                        sd.add_dependency(self._last_horizon, DepKind.SYNC)
                    self._emit(sd)
                    sends.append(sd)
                    self.pilots.append(Pilot(
                        source=self.node, target=m.dst, transfer_id=rtid_k,
                        box=cmd.buffer.full_box, msg_id=msg_id, gather=True))
        shared = dict(recvs=recvs, sends=sends)
        for rtid, _ in members:
            self._coll_red[rtid]["shared"] = shared

    def _compile_allreduce(self, cmd: Command) -> None:
        """Lower the (fused) reduction exchange as reduce-scatter + shard
        allgather (DESIGN.md §9) — ~2/N of the full-partial bytes.

        Phase 1 (recursive halving over the participants): each message
        ships, per fused member, the partial sums of one *slot range* out
        of the flat accumulator; the receiver lands them in a one-shot
        scratch and a LOCAL_REDUCE folds them into the half it keeps
        (fold-on-receive) — communication and fold work interleave inside
        the schedule.  Phase 2 (dissemination allgather over ALL nodes):
        the final folded shards travel as overwrite fragments, landing
        straight into every rank's accumulator.  Both phases share the
        round-tagged transfer-id space of the exchange (allgather rounds
        are offset by the reduce-scatter round count), so rounds remain
        independently schedulable and interleave with other collectives.
        """
        members = cmd.coll_members                 # ((rtid, Reduction), ...)
        group = cmd.coll_group                     # all nodes
        rs_rounds, owner, m = reduce_scatter_schedule(cmd.participants)
        # per fused member: staging accumulator + slot-space shard bounds
        info = []
        for rtid, red in members:
            cst = self._red_staging_flat(rtid, red)
            bounds = shard_bounds(cst["staging"].box.shape[0], m)
            info.append((cst, cst["staging"], red, bounds))
        lane = f"N{self.node}.coll.t{cmd.transfer_id[0]}b{cmd.transfer_id[1]}"
        all_sends: list[Instruction] = []
        ag_recvs: list[Instruction] = []

        def sync_dep(instr: Instruction) -> None:
            if self._last_horizon is not None:
                instr.add_dependency(self._last_horizon, DepKind.SYNC)

        # -- phase 1: reduce-scatter (fold-on-receive) --------------------
        for k, msgs in enumerate(rs_rounds):
            rtid_k = cmd.transfer_id + (k,)
            for msg in msgs:
                s_lo, s_hi = msg.shards
                spans = [(mi, b[s_lo], b[s_hi])
                         for mi, (_, _, _, b) in enumerate(info)
                         if b[s_lo] < b[s_hi]]
                if not spans:
                    continue               # every member's range is empty
                if msg.dst == self.node:
                    scr = {}
                    for mi, lo, hi in spans:
                        cst, _, red, _ = info[mi]
                        scr[mi] = self.mem.scratch(
                            PINNED_HOST, Box((0,), (hi - lo,)),
                            red.op.acc_dtype(red.buffer.dtype),
                            f"alloc rs-recv {red.buffer.name} r{k}")
                    land = tuple(CollFragment(key=(mi, lo, hi),
                                              alloc=scr[mi],
                                              srange=(0, hi - lo))
                                 for mi, lo, hi in spans)
                    rc = Instruction(
                        InstructionType.COLL_RECV, node=self.node,
                        queue=("comm",), transfer_id=rtid_k,
                        coll_source=msg.src,
                        coll_allocs=tuple(scr[mi] for mi, _, _ in spans),
                        coll_expect=tuple(f.key for f in land),
                        coll_land=land, command=cmd, trace_lane=lane,
                        name=f"rs-recv r{k} {cmd.buffer.name} <-N{msg.src}")
                    for a in rc.coll_allocs:
                        rc.add_dependency(a.alloc_instr, DepKind.TRUE)
                    sync_dep(rc)
                    self._emit(rc)
                    for mi, lo, hi in spans:
                        cst, staging, red, _ = info[mi]
                        fold = Instruction(
                            InstructionType.LOCAL_REDUCE, node=self.node,
                            queue=("host",), reduction=red,
                            reduce_srcs=(scr[mi],), dst_alloc=staging,
                            slot_range=(lo, hi), accumulate=True,
                            command=cmd, trace_lane=lane,
                            name=(f"fold r{k} {red.buffer.name} "
                                  f"[{lo}:{hi})"))
                        fold.add_dependency(rc, DepKind.TRUE)
                        fold.add_dependency(staging.alloc_instr, DepKind.TRUE)
                        fold.add_dependency(scr[mi].alloc_instr, DepKind.TRUE)
                        if cst["tail"] is not None:
                            fold.add_dependency(cst["tail"], DepKind.TRUE)
                        self._emit(fold)
                        cst["tail"] = fold
                        self.mem.free_scratch(scr[mi], [fold])
                if msg.src == self.node:
                    frags = tuple(CollFragment(key=(mi, lo, hi),
                                               alloc=info[mi][1],
                                               srange=(lo, hi))
                                  for mi, lo, hi in spans)
                    msg_id = next(self._msg_ids)
                    sd = Instruction(
                        InstructionType.COLL_SEND, node=self.node,
                        queue=("comm",), dest=msg.dst, msg_id=msg_id,
                        transfer_id=rtid_k, coll_frags=frags, command=cmd,
                        trace_lane=lane,
                        name=f"rs-send r{k} {cmd.buffer.name} ->N{msg.dst}")
                    for mi, lo, hi in spans:
                        cst, staging, _, _ = info[mi]
                        sd.add_dependency(staging.alloc_instr, DepKind.TRUE)
                        if cst["tail"] is not None:
                            sd.add_dependency(cst["tail"], DepKind.TRUE)
                    sync_dep(sd)
                    self._emit(sd)
                    all_sends.append(sd)
                    self.pilots.append(Pilot(
                        source=self.node, target=msg.dst, transfer_id=rtid_k,
                        box=cmd.buffer.full_box, msg_id=msg_id, gather=True))

        # -- phase 2: allgather of the folded shards ----------------------
        # a rank contributes iff its shard is non-empty for ANY member;
        # per-member empty fragments are skipped inside each message
        contributors = tuple(sorted(
            r for r, s in owner.items()
            if any(b[s] < b[s + 1] for _, _, _, b in info)))
        ag_rounds = allgather_schedule(group, contributors)
        off = len(rs_rounds)
        shard_src: dict[int, Instruction] = {}     # owner rank -> landing rc

        def shard_frags(blocks):
            """Per-member fragments of the given owners' shards — the SAME
            construction on both sides of a message, so sender keys and
            receiver expected keys never diverge."""
            return tuple(
                CollFragment(key=(mi, b), alloc=staging,
                             srange=(bounds[owner[b]], bounds[owner[b] + 1]))
                for b in blocks
                for mi, (_, staging, _, bounds) in enumerate(info)
                if bounds[owner[b]] < bounds[owner[b] + 1])

        for k, msgs in enumerate(ag_rounds):
            rtid_k = cmd.transfer_id + (off + k,)
            for msg in msgs:
                if msg.dst == self.node:
                    land = shard_frags(msg.blocks)
                    rc = Instruction(
                        InstructionType.COLL_RECV, node=self.node,
                        queue=("comm",), transfer_id=rtid_k,
                        coll_source=msg.src,
                        coll_allocs=tuple(st for _, st, _, _ in info),
                        coll_expect=tuple(f.key for f in land),
                        coll_land=tuple(land), command=cmd, trace_lane=lane,
                        name=f"ag-recv r{k} {cmd.buffer.name} <-N{msg.src}")
                    for _, staging, _, _ in info:
                        rc.add_dependency(staging.alloc_instr, DepKind.TRUE)
                    # landing overwrites partially folded ranges: after the
                    # fold chain and every reduce-scatter send that read them
                    for cst, _, _, _ in info:
                        if cst["tail"] is not None:
                            rc.add_dependency(cst["tail"], DepKind.ANTI)
                    for sd in all_sends:
                        rc.add_dependency(sd, DepKind.ANTI)
                    sync_dep(rc)
                    self._emit(rc)
                    ag_recvs.append(rc)
                    for b in msg.blocks:
                        shard_src[b] = rc
                if msg.src == self.node:
                    msg_id = next(self._msg_ids)
                    sd = Instruction(
                        InstructionType.COLL_SEND, node=self.node,
                        queue=("comm",), dest=msg.dst, msg_id=msg_id,
                        transfer_id=rtid_k, coll_frags=shard_frags(msg.blocks),
                        command=cmd, trace_lane=lane,
                        name=f"ag-send r{k} {cmd.buffer.name} ->N{msg.dst}")
                    for cst, staging, _, _ in info:
                        sd.add_dependency(staging.alloc_instr, DepKind.TRUE)
                    for b in msg.blocks:
                        rc = shard_src.get(b)
                        if rc is not None:
                            sd.add_dependency(rc, DepKind.TRUE)
                        else:          # own fully folded shard
                            for cst, _, _, _ in info:
                                if cst["tail"] is not None:
                                    sd.add_dependency(cst["tail"],
                                                      DepKind.TRUE)
                    sync_dep(sd)
                    self._emit(sd)
                    all_sends.append(sd)
                    self.pilots.append(Pilot(
                        source=self.node, target=msg.dst, transfer_id=rtid_k,
                        box=cmd.buffer.full_box, msg_id=msg_id, gather=True))
        shared = dict(recvs=ag_recvs, sends=all_sends)
        for rtid, _ in members:
            self._coll_red[rtid]["shared"] = shared

    def _compile_reduce_global(self, cmd: Command) -> None:
        """Gather peer partials and fold them in canonical node order."""
        if cmd.collective:
            self._compile_reduce_global_collective(cmd)
            return
        red, buf = cmd.reduction, cmd.buffer
        self._register(buf)
        st = self._red_state.pop(cmd.transfer_id,
                                 {"device": [], "partial": None, "sends": []})
        own_partial = st["partial"]           # (alloc, LOCAL_REDUCE) | None
        peers = tuple(s for s in cmd.participants if s != self.node)

        gather_alloc = None
        gather_instr = None
        if peers:
            # fixed-stride gather staging: slot s holds rank s's partial
            slots = max(peers) + 1
            gbox = Box((0,) * (buf.full_box.rank + 1), (slots,) + buf.shape)
            gather_alloc = self.mem.scratch(
                PINNED_HOST, gbox, red.op.acc_dtype(buf.dtype),
                f"alloc red-gather {buf.name}")
            gather_instr = Instruction(
                InstructionType.GATHER_RECEIVE, node=self.node,
                queue=("comm",), transfer_id=cmd.transfer_id,
                recv_region=buf.full_region, recv_alloc=gather_alloc,
                gather_sources=peers, reduction=red, command=cmd,
                name=f"gather-recv {buf.name} <-{{{','.join(map(str, peers))}}}")
            gather_instr.add_dependency(gather_alloc.alloc_instr, DepKind.TRUE)
            if self._last_horizon is not None:
                gather_instr.add_dependency(self._last_horizon, DepKind.SYNC)
            self._emit(gather_instr)

        # the combined value lands in the buffer's host backing allocation
        dst = self.mem.ensure(buf, PINNED_HOST, buf.full_box)
        full = buf.full_region
        if red.include_current_value:
            # previous contents enter the fold exactly once — every node
            # holds the same replicated value, so this stays deterministic
            self.mem.make_coherent(buf, PINNED_HOST, full)
        ms = self.mem.state(buf.bid, PINNED_HOST)
        gi = Instruction(
            InstructionType.GLOBAL_REDUCE, node=self.node, queue=("host",),
            reduction=red, src_alloc=gather_alloc,
            reduce_srcs=(own_partial[0],) if own_partial else (),
            dst_alloc=dst, participants=cmd.participants,
            include_current=red.include_current_value, command=cmd,
            name=f"global-reduce {buf.name} ({red.op.name})")
        if dst.alloc_instr is not None:
            gi.add_dependency(dst.alloc_instr, DepKind.TRUE)
        if gather_instr is not None:
            gi.add_dependency(gather_instr, DepKind.TRUE)
        if own_partial is not None:
            gi.add_dependency(own_partial[1], DepKind.TRUE)
        kind = DepKind.TRUE if red.include_current_value else DepKind.OUTPUT
        for sub, producer in ms.producers.query(full):
            gi.add_dependency(producer, kind)
        for r, reader in ms.readers:
            if r.overlaps(full):
                gi.add_dependency(reader, DepKind.ANTI)
        if self._last_horizon is not None:
            gi.add_dependency(self._last_horizon, DepKind.SYNC)
        self._emit(gi)
        ms.producers.update(full, gi)
        ms.readers = [(r, t) for r, t in ms.readers
                      if not r.difference(full).is_empty()]
        self.mem.coherence[buf.bid].update(full, frozenset([PINNED_HOST]))
        self.mem.note_write(buf.bid, full)
        # scratch lifetimes: the gather staging dies with the fold; the node
        # partial must also outlive every outbound broadcast send
        if gather_alloc is not None:
            self.mem.free_scratch(gather_alloc, [gi])
        if own_partial is not None:
            self.mem.free_scratch(own_partial[0], [gi] + st["sends"])

    def _compile_reduce_global_collective(self, cmd: Command) -> None:
        """Collective-mode fold: every participant slot (own included) is in
        the staging allocation, so the fold reads ``staging[s]`` for all
        ``s`` in canonical order (``slot_all``) — bitexactness per fused
        component is untouched, only the transport changed."""
        red, buf = cmd.reduction, cmd.buffer
        self._register(buf)
        self._red_state.pop(cmd.transfer_id, None)
        cst = self._coll_red.pop(cmd.transfer_id)
        staging = cst["staging"]
        shared = cst.get("shared", {})
        allreduce = cst.get("mode") == "allreduce"
        dst = self.mem.ensure(buf, PINNED_HOST, buf.full_box)
        full = buf.full_region
        if red.include_current_value:
            self.mem.make_coherent(buf, PINNED_HOST, full)
        ms = self.mem.state(buf.bid, PINNED_HOST)
        gi = Instruction(
            InstructionType.GLOBAL_REDUCE, node=self.node, queue=("host",),
            reduction=red, src_alloc=staging, dst_alloc=dst,
            slot_all=not allreduce, prefolded=allreduce,
            participants=cmd.participants,
            include_current=red.include_current_value, command=cmd,
            name=f"global-reduce {buf.name} ({red.op.name})")
        gi.add_dependency(staging.alloc_instr, DepKind.TRUE)
        if dst.alloc_instr is not None:
            gi.add_dependency(dst.alloc_instr, DepKind.TRUE)
        lr = cst.get("tail") if allreduce else cst.get("local")
        if lr is not None:
            gi.add_dependency(lr, DepKind.TRUE)
        for rc in shared.get("recvs", ()):
            gi.add_dependency(rc, DepKind.TRUE)
        kind = DepKind.TRUE if red.include_current_value else DepKind.OUTPUT
        for sub, producer in ms.producers.query(full):
            gi.add_dependency(producer, kind)
        for r, reader in ms.readers:
            if r.overlaps(full):
                gi.add_dependency(reader, DepKind.ANTI)
        if self._last_horizon is not None:
            gi.add_dependency(self._last_horizon, DepKind.SYNC)
        self._emit(gi)
        ms.producers.update(full, gi)
        ms.readers = [(r, t) for r, t in ms.readers
                      if not r.difference(full).is_empty()]
        self.mem.coherence[buf.bid].update(full, frozenset([PINNED_HOST]))
        self.mem.note_write(buf.bid, full)
        # the member staging dies with its fold, but must outlive every
        # packed exchange send of the whole fusion group
        self.mem.free_scratch(staging, [gi] + list(shared.get("sends", ())))

    # -- region collectives (DESIGN.md §9) ------------------------------------
    def _compile_collective(self, cmd: Command) -> None:
        """Lower a region collective into O(log N) rounds of COLL_SEND /
        COLL_RECV against the buffer's pinned-host backing allocation."""
        buf = cmd.buffer
        self._register(buf)
        kind = {CommandType.COLL_ALLGATHER: "allgather",
                CommandType.COLL_BROADCAST: "broadcast",
                CommandType.COLL_SCATTER: "scatter"}[cmd.ctype]
        group, blocks, root = cmd.coll_group, cmd.coll_blocks, cmd.coll_root
        rounds = schedule_for(kind, group, contributors=tuple(sorted(blocks)),
                              root=root)
        if kind == "allgather":
            own_region = blocks.get(self.node, Region.empty())
        else:
            own_region = Region.empty()
            if self.node == root:
                for r in blocks.values():
                    own_region = own_region.union(r)
        recv_region = Region.empty()
        for msgs in rounds:
            for m in msgs:
                if m.dst == self.node:
                    for b in m.blocks:
                        recv_region = recv_region.union(blocks[b])
        touched = own_region.union(recv_region)
        if touched.is_empty():
            return
        alloc = self.mem.ensure(buf, PINNED_HOST, touched.bounding_box())
        if not own_region.is_empty():
            self.mem.make_coherent(buf, PINNED_HOST, own_region)
        ms = self.mem.state(buf.bid, PINNED_HOST)
        anti_deps: list[Instruction] = []
        if not recv_region.is_empty():
            for r, reader in ms.readers:
                if r.overlaps(recv_region):
                    anti_deps.append(reader)
            for sub, w in ms.producers.query(recv_region):
                anti_deps.append(w)
        lane = f"N{self.node}.coll.t{cmd.transfer_id[0]}b{cmd.transfer_id[1]}"
        block_src: dict[int, Instruction] = {}     # block id -> landing recv
        for k, msgs in enumerate(rounds):
            rtid_k = cmd.transfer_id + (k,)
            for m in msgs:
                if m.dst == self.node:
                    landed = Region.empty()
                    for b in m.blocks:
                        landed = landed.union(blocks[b])
                    expect = tuple(bx for b in m.blocks
                                   for bx in blocks[b].boxes)
                    rc = Instruction(
                        InstructionType.COLL_RECV, node=self.node,
                        queue=("comm",), transfer_id=rtid_k,
                        coll_source=m.src, coll_allocs=(alloc,),
                        coll_expect=expect, recv_region=landed,
                        recv_alloc=alloc, command=cmd, trace_lane=lane,
                        name=f"coll-recv r{k} {buf.name} <-N{m.src}")
                    rc.add_dependency(alloc.alloc_instr, DepKind.TRUE)
                    for a in anti_deps:
                        rc.add_dependency(a, DepKind.ANTI)
                    if self._last_horizon is not None:
                        rc.add_dependency(self._last_horizon, DepKind.SYNC)
                    self._emit(rc)
                    ms.producers.update(landed, rc)
                    for b in m.blocks:
                        block_src[b] = rc
                if m.src == self.node:
                    frags = tuple(CollFragment(key=bx, alloc=alloc, box=bx)
                                  for b in m.blocks
                                  for bx in blocks[b].boxes)
                    sent = Region.empty()
                    for b in m.blocks:
                        sent = sent.union(blocks[b])
                    msg_id = next(self._msg_ids)
                    sd = Instruction(
                        InstructionType.COLL_SEND, node=self.node,
                        queue=("comm",), dest=m.dst, msg_id=msg_id,
                        transfer_id=rtid_k, coll_frags=frags, command=cmd,
                        trace_lane=lane,
                        name=f"coll-send r{k} {buf.name} ->N{m.dst}")
                    sd.add_dependency(alloc.alloc_instr, DepKind.TRUE)
                    for b in m.blocks:
                        rc = block_src.get(b)
                        if rc is not None:
                            sd.add_dependency(rc, DepKind.TRUE)
                        else:   # own data: depend on its producers
                            for psub, producer in ms.producers.query(blocks[b]):
                                sd.add_dependency(producer, DepKind.TRUE)
                    if self._last_horizon is not None:
                        sd.add_dependency(self._last_horizon, DepKind.SYNC)
                    self._emit(sd)
                    ms.readers.append((sent, sd))
                    self.pilots.append(Pilot(
                        source=self.node, target=m.dst, transfer_id=rtid_k,
                        box=sent.bounding_box(), msg_id=msg_id))
        if not recv_region.is_empty():
            # fresh remote data supersedes stale local replicas + spills
            self.mem.coherence[buf.bid].update(recv_region,
                                               frozenset([PINNED_HOST]))
            self.mem.note_write(buf.bid, recv_region)

    # -- synchronization (§3.5) ---------------------------------------------
    def _compile_sync(self, cmd: Command, itype: InstructionType) -> None:
        instr = Instruction(itype, node=self.node, queue=("host",),
                            name=itype.value, command=cmd)
        # every instruction before the previous sync already has a dependent
        # (that sync), so only the tail can contribute to the frontier
        for i in self.instructions[self._frontier_pos:]:
            if not i.dependents:
                instr.add_dependency(i, DepKind.SYNC)
        self._emit(instr)
        if itype == InstructionType.HORIZON:
            self._last_horizon = instr
        else:
            self._last_epoch = instr
            self._last_horizon = None
        # horizon compaction: prior producers collapse onto the sync point
        self.mem.compact_at_sync(instr)
        if self.retire:
            # everything before this sync is transitively dominated by it;
            # the generator only ever wires new deps against the sync point
            del self.instructions[:-1]
            self._frontier_pos = 0
        else:
            self._frontier_pos = len(self.instructions) - 1

    # -- shutdown -------------------------------------------------------------
    def free_all(self) -> list[Instruction]:
        """Emit frees for all live allocations (buffer destruction, §3.2)."""
        return self.mem.free_all()
