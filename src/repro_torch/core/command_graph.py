# Copied from src/repro/core/command_graph.py.
"""Command graph (CDAG) generation — paper §2.4.

The CDAG distributes each task's kernel index space onto cluster nodes and
models the peer-to-peer communication (push / await-push) needed to satisfy
the resulting data dependencies.  Generation is a *replicated deterministic*
process: every node computes the same global ownership information, but only
materializes the commands it will itself execute.  Push commands carry the
precise target and region; await-push commands only know the *union* of
subregions that will arrive for a task (the paper's scalability trade-off,
§3.4) — which is what later forces split-receive handling in the IDAG.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from .buffer import VirtualBuffer
from .collective import schedule_for
from .reduction import Reduction
from .region import Box, Region, RegionMap, split_box
from .task_graph import DepKind, Task, TaskGraph, TaskType


class CommandType(enum.Enum):
    EXECUTION = "execution"
    PUSH = "push"
    AWAIT_PUSH = "await_push"
    # reductions (§2.2): N partial producers -> 1 replicated value.  Each
    # participating node combines its device partials and broadcasts them
    # (REDUCE_PARTIAL); every node then gathers all partials and folds them
    # in canonical node order (REDUCE_GLOBAL) — replicated-deterministic.
    REDUCE_PARTIAL = "reduce_partial"
    REDUCE_GLOBAL = "reduce_global"
    # collective exchanges (DESIGN.md §9): detected from the replicated
    # all-pairs picture and lowered into O(log N) topology rounds.  One
    # command per involved node; the point-to-point PUSH/AWAIT_PUSH path is
    # kept for irregular / partial-overlap exchanges.
    COLL_ALLGATHER = "coll_allgather"
    COLL_BROADCAST = "coll_broadcast"
    COLL_SCATTER = "coll_scatter"
    # reduce-scatter + allgather allreduce (DESIGN.md §9): the reduction
    # exchange of a fusion group whose members all have an order-free
    # combine.  Carries the same member metadata as the fused allgather;
    # the IDAG derives the two-phase schedule from the replicated
    # participant set.  The slot-allgather exchange stays available as the
    # fallback/oracle path (``allreduce=False``).
    COLL_ALLREDUCE = "coll_allreduce"
    HORIZON = "horizon"
    EPOCH = "epoch"


_cmd_ids = itertools.count()


@dataclass
class Command:
    ctype: CommandType
    node: int
    task: Optional[Task] = None
    chunk: Optional[Box] = None                 # EXECUTION: this node's chunk
    buffer: Optional[VirtualBuffer] = None      # PUSH/AWAIT_PUSH/REDUCE_*
    region: Optional[Region] = None             # PUSH: precise; AWAIT: union
    target: Optional[int] = None                # PUSH only
    # PUSH/AWAIT: (task id, buffer id); REDUCE_*: (task id, buffer id, 1) so
    # gather traffic never aliases include_current_value coherence transfers
    transfer_id: Optional[tuple] = None
    reduction: Optional[Reduction] = None       # REDUCE_* only
    participants: tuple[int, ...] = ()          # REDUCE_*: nodes with chunks
    targets: tuple[int, ...] = ()               # REDUCE_PARTIAL: broadcast set
    # collective metadata (COLL_*, replicated on every node; DESIGN.md §9)
    coll_group: tuple[int, ...] = ()            # ordered exchange group
    coll_blocks: Optional[dict] = None          # block rank -> Region
    coll_root: Optional[int] = None             # broadcast/scatter root
    # fused reduction exchange: ((rtid, Reduction), ...) member components
    coll_members: tuple = ()
    # REDUCE_PARTIAL/REDUCE_GLOBAL lowered in collective (staging-slot) mode
    collective: bool = False
    # reduction exchange lowered as reduce-scatter + allgather (flat
    # slot-space staging) instead of the full-partial slot allgather
    allreduce: bool = False
    cid: int = field(default_factory=lambda: next(_cmd_ids))
    dependencies: list[tuple["Command", DepKind]] = field(default_factory=list)
    dependents: list["Command"] = field(default_factory=list)

    def add_dependency(self, dep: "Command", kind: DepKind) -> None:
        if dep is self:
            return
        for d, _ in self.dependencies:
            if d is dep:
                return
        self.dependencies.append((dep, kind))
        dep.dependents.append(self)

    def __hash__(self) -> int:
        return self.cid

    def __repr__(self) -> str:
        t = f":{self.task.name}" if self.task else ""
        return f"C{self.cid}<{self.ctype.value}{t}@N{self.node}>"


@dataclass
class _NodeBufferState:
    last_writers: RegionMap                     # region -> local Command
    last_readers: list[tuple[Region, Command]] = field(default_factory=list)


class CommandGraphGenerator:
    """Generates per-node command graphs from a TDAG stream."""

    def __init__(self, num_nodes: int, *, retire_for: Optional[int] = None,
                 collectives: bool = False, allreduce: bool = True):
        self.num_nodes = num_nodes
        # ``collectives=True`` turns all-pairs exchange patterns into COLL_*
        # commands and reduction exchanges into (fusable) allgathers; the
        # point-to-point path remains for irregular exchanges and is the
        # default for structural/back-compat consumers (``generate_cdag``).
        self.collectives = collectives
        # ``allreduce=True`` (with collectives): reduction exchanges whose
        # members all have an order-free combine lower as reduce-scatter +
        # allgather (~2/N of the full-partial bytes); ``False`` keeps the
        # slot-allgather exchange everywhere (the fallback/oracle path).
        # Below 3 nodes the decomposition cannot reduce bytes (every slot
        # crosses the wire once per direction regardless) and only doubles
        # the message count, so the fallback stays in charge there.
        self.allreduce = allreduce and collectives and num_nodes >= 3
        # open fused-reduction group: reduction exchanges are deferred until
        # the fusion chain breaks (next non-fusable task, horizon or epoch),
        # then emitted as ONE packed allgather + per-member REDUCE_GLOBALs
        self._open_red: Optional[dict] = None
        self.commands: list[list[Command]] = [[] for _ in range(num_nodes)]
        # ``retire_for=k`` (runtime mode, one generator per node scheduler):
        # at every horizon/epoch the per-node command lists are trimmed to
        # the new sync command, so CDAG memory is O(window) on long runs.
        # Commands of nodes != k also get their dependency lists cleared at
        # the sync (nothing ever compiles them here); node k's edges are
        # cleared by the lookahead once each command is lowered.
        # ``emitted_counts`` keeps the lifetime totals.
        self.retire_for = retire_for
        self.emitted_counts: list[int] = [0] * num_nodes
        # replicated global ownership: buffer -> RegionMap(region -> owner rank)
        self._ownership: dict[int, RegionMap] = {}
        self._buffers: dict[int, VirtualBuffer] = {}
        self._node_state: list[dict[int, _NodeBufferState]] = [dict() for _ in range(num_nodes)]
        self._init_epochs: list[Command] = []
        self._last_horizon: list[Optional[Command]] = [None] * num_nodes
        self._last_epoch: list[Optional[Command]] = [None] * num_nodes
        self._frontier_pos: list[int] = [0] * num_nodes  # last sync cmd index
        self.errors: list[str] = []
        for n in range(num_nodes):
            epoch = Command(CommandType.EPOCH, node=n, task=None)
            self._add(n, epoch)
            self._init_epochs.append(epoch)
            self._last_epoch[n] = epoch

    def _add(self, n: int, cmd: Command) -> None:
        self.commands[n].append(cmd)
        self.emitted_counts[n] += 1

    # ------------------------------------------------------------------
    def _ownership_map(self, buf: VirtualBuffer) -> RegionMap:
        m = self._ownership.get(buf.bid)
        if m is None:
            # buffers with initial values are replicated on every node at t=0;
            # we mark rank 0 as canonical owner and all nodes as up-to-date.
            m = RegionMap(buf.full_box, default=frozenset(range(self.num_nodes))
                          if buf.initial_value is not None else None)
            self._ownership[buf.bid] = m
            self._buffers[buf.bid] = buf
        return m

    def _node_buf(self, node: int, buf: VirtualBuffer) -> _NodeBufferState:
        st = self._node_state[node].get(buf.bid)
        if st is None:
            st = _NodeBufferState(
                last_writers=RegionMap(buf.full_box, default=self._init_epochs[node]))
            self._node_state[node][buf.bid] = st
        return st

    # ------------------------------------------------------------------
    def process(self, task: Task) -> list[Command]:
        if task.ttype == TaskType.HORIZON:
            return self._flush_reductions() + self._emit_sync(task, CommandType.HORIZON)
        if task.ttype == TaskType.EPOCH:
            return self._flush_reductions() + self._emit_sync(task, CommandType.EPOCH)
        return self._process_kernel(task)

    def _emit_sync(self, task: Task, ctype: CommandType) -> list[Command]:
        out = []
        for n in range(self.num_nodes):
            cmd = Command(ctype, node=n, task=task)
            # commands before the previous sync already have a dependent
            # (that sync): only the tail can contribute to the frontier
            for c in self.commands[n][self._frontier_pos[n]:]:
                if not c.dependents:
                    cmd.add_dependency(c, DepKind.SYNC)
            self._add(n, cmd)
            self._frontier_pos[n] = len(self.commands[n]) - 1
            if ctype == CommandType.HORIZON:
                self._last_horizon[n] = cmd
            else:
                self._last_epoch[n] = cmd
                self._last_horizon[n] = None
            # horizon compaction of per-node tracking structures
            for st in self._node_state[n].values():
                st.last_writers.update(st.last_writers.covered(), cmd)
                st.last_writers.coalesce()
                st.last_readers = []
            if self.retire_for is not None:
                # everything before this sync is dominated by it; the
                # tracking maps above now reference only the sync command
                if n != self.retire_for:
                    for c in self.commands[n][:-1]:
                        c.dependencies.clear()
                        c.dependents.clear()
                del self.commands[n][:-1]
                self._frontier_pos[n] = 0
            out.append(cmd)
        return out

    # ------------------------------------------------------------------
    def _fetch_missing(self, n: int, buf: VirtualBuffer, need: Region,
                       task: Task, consumer: Command,
                       new_cmds: list[Command]) -> None:
        """Emit sender pushes + one await-push so ``need`` is up-to-date on
        node ``n``; wires the await-push as a TRUE dep of ``consumer``."""
        own = self._ownership_map(buf)
        missing_union = Region.empty()
        for sub, owner in own.query(need):
            if owner is None:
                continue  # uninitialized — TDAG already warned
            owners = owner if isinstance(owner, frozenset) else frozenset([owner])
            if n in owners:
                continue
            src = min(owners)  # deterministic sender choice
            missing_union = missing_union.union(sub)
            # sender-side push (materialized on the sender node)
            push = Command(CommandType.PUSH, node=src, task=task, buffer=buf,
                           region=sub, target=n,
                           transfer_id=(task.tid, buf.bid))
            sst = self._node_buf(src, buf)
            for ssub, writer in sst.last_writers.query(sub):
                push.add_dependency(writer, DepKind.TRUE)
            sst.last_readers.append((sub, push))
            self._add(src, push)
            new_cmds.append(push)
        if not missing_union.is_empty():
            ap = Command(CommandType.AWAIT_PUSH, node=n, task=task, buffer=buf,
                         region=missing_union,
                         transfer_id=(task.tid, buf.bid))
            nst = self._node_buf(n, buf)
            # anti-dep: receive overwrites stale local data
            for ssub, writer in nst.last_writers.query(missing_union):
                ap.add_dependency(writer, DepKind.ANTI)
            for rreg, reader in nst.last_readers:
                if rreg.overlaps(missing_union):
                    ap.add_dependency(reader, DepKind.ANTI)
            nst.last_writers.update(missing_union, ap)
            self._add(n, ap)
            new_cmds.append(ap)
            consumer.add_dependency(ap, DepKind.TRUE)
            # received data is now also up-to-date on n (replicated info)
            for sub, owner in own.query(missing_union):
                owners = owner if isinstance(owner, frozenset) else frozenset([owner])
                own.update(sub, owners | {n})

    def _fetch_missing_grouped(self, task: Task, buf: VirtualBuffer,
                               needs: dict[int, Region],
                               consumers: dict[int, Command],
                               new_cmds: list[Command]) -> None:
        """Coherence pre-fetch for several consumers of the same buffer —
        as ONE broadcast when a single owner serves every participant
        (the ``include_current_value`` shape; ROADMAP "collectivize
        include_current"), point-to-point pushes otherwise."""
        if self.collectives:
            coll = self._classify_exchange(buf, needs)
            if coll is not None and coll["kind"] == "broadcast":
                self._emit_collective(task, buf, coll, needs, consumers,
                                      new_cmds)
                return
        for n, need in needs.items():
            self._fetch_missing(n, buf, need, task, consumers[n], new_cmds)

    # ------------------------------------------------------------------
    def _process_kernel(self, task: Task) -> list[Command]:
        chunks = split_box(task.index_space, self.num_nodes,
                           dims=task.split_dims, granularity=task.granularity)
        # node i executes chunk i (static assignment); nodes beyond the chunk
        # count execute nothing for this task.
        node_chunks: dict[int, Box] = {i: c for i, c in enumerate(chunks)}
        new_cmds: list[Command] = []

        # fused-reduction scope: the open group survives only while the
        # (replicated) TDAG fusion chain continues AND the participant set
        # is unchanged; otherwise its deferred exchange flushes first, so
        # this task observes the folded results as the last writers.
        if self._open_red is not None:
            fusable = (task.reductions and task.fuse_with_prev
                       and tuple(sorted(node_chunks))
                       == self._open_red["participants"]
                       # the exchange mode (allreduce vs slot allgather) is
                       # per group: an order-free task never shares a packed
                       # exchange with a canonical-order one
                       and self._order_free(task)
                       == self._open_red["order_free"])
            if not fusable:
                new_cmds.extend(self._flush_reductions())

        # --- pass 1: writer-ownership + overlapping-write detection -------
        writes_per_node: dict[int, dict[int, Region]] = {}
        for n, chunk in node_chunks.items():
            for acc in task.accessors:
                if acc.mode.is_producer:
                    reg = acc.mapped_region(chunk)
                    writes_per_node.setdefault(acc.buffer.bid, {})[n] = \
                        writes_per_node.get(acc.buffer.bid, {}).get(n, Region.empty()).union(reg)
        for bid, per_node in writes_per_node.items():
            nodes = list(per_node)
            for i in range(len(nodes)):
                for j in range(i + 1, len(nodes)):
                    if per_node[nodes[i]].overlaps(per_node[nodes[j]]):
                        self.errors.append(
                            f"overlapping writes to {self._buffers.get(bid, bid)} by nodes "
                            f"{nodes[i]} and {nodes[j]} in task {task.name}")

        # --- pass 2: reads → pushes / await-pushes ------------------------
        exec_cmds: dict[int, Command] = {}
        for n, chunk in node_chunks.items():
            cmd = Command(CommandType.EXECUTION, node=n, task=task, chunk=chunk)
            exec_cmds[n] = cmd

        if self.collectives:
            handled: set[int] = set()
            for acc in task.accessors:
                if not acc.mode.is_consumer or acc.buffer.bid in handled:
                    continue
                handled.add(acc.buffer.bid)
                self._exchange_buffer(task, acc.buffer, node_chunks,
                                      exec_cmds, new_cmds)
        else:
            for n, chunk in node_chunks.items():
                cmd = exec_cmds[n]
                for acc in task.accessors:
                    if not acc.mode.is_consumer:
                        continue
                    need = acc.mapped_region(chunk)
                    self._fetch_missing(n, acc.buffer, need, task, cmd, new_cmds)

        # --- pass 3: local deps + ownership update for writes -------------
        for n, chunk in node_chunks.items():
            cmd = exec_cmds[n]
            for acc in task.accessors:
                buf = acc.buffer
                nst = self._node_buf(n, buf)
                if acc.mode.is_consumer:
                    need = acc.mapped_region(chunk)
                    for sub, writer in nst.last_writers.query(need):
                        cmd.add_dependency(writer, DepKind.TRUE)
                    nst.last_readers.append((need, cmd))
                if acc.mode.is_producer:
                    wreg = acc.mapped_region(chunk)
                    for rreg, reader in nst.last_readers:
                        if reader is not cmd and rreg.overlaps(wreg):
                            cmd.add_dependency(reader, DepKind.ANTI)
                    for sub, writer in nst.last_writers.query(wreg):
                        cmd.add_dependency(writer, DepKind.OUTPUT)
                    nst.last_writers.update(wreg, cmd)
                    nst.last_readers = [(r, t) for r, t in nst.last_readers
                                        if not r.difference(wreg).is_empty() or t is cmd]
            if not cmd.dependencies and self._last_epoch[n] is not None:
                cmd.add_dependency(self._last_epoch[n], DepKind.SYNC)
            if self._last_horizon[n] is not None:
                cmd.add_dependency(self._last_horizon[n], DepKind.SYNC)
            self._add(n, cmd)
            new_cmds.append(cmd)

        # global ownership update: writers become exclusive owners
        for acc in task.accessors:
            if acc.mode.is_producer:
                own = self._ownership_map(acc.buffer)
                for n, chunk in node_chunks.items():
                    own.update(acc.mapped_region(chunk), frozenset([n]))

        # --- pass 4: reductions (N partials -> 1 replicated value) ---------
        if self.collectives:
            if task.reductions:
                self._queue_reductions(task, node_chunks, exec_cmds, new_cmds)
        else:
            for red in task.reductions:
                self._process_reduction(task, red, node_chunks, exec_cmds,
                                        new_cmds)
        return new_cmds

    # -- collective exchange detection (DESIGN.md §9) ---------------------
    def _exchange_buffer(self, task: Task, buf: VirtualBuffer,
                         node_chunks: dict[int, Box],
                         exec_cmds: dict[int, Command],
                         new_cmds: list[Command]) -> None:
        """Satisfy every node's reads of ``buf`` for this task — as ONE
        collective when the all-pairs picture matches a known topology,
        falling back to the historical per-accessor point-to-point path."""
        needs: dict[int, Region] = {}
        for n, chunk in node_chunks.items():
            r = Region.empty()
            for acc in task.accessors:
                if acc.buffer.bid == buf.bid and acc.mode.is_consumer:
                    r = r.union(acc.mapped_region(chunk))
            if not r.is_empty():
                needs[n] = r
        coll = self._classify_exchange(buf, needs)
        if coll is None:
            for n, chunk in node_chunks.items():
                cmd = exec_cmds[n]
                for acc in task.accessors:
                    if acc.buffer.bid == buf.bid and acc.mode.is_consumer:
                        self._fetch_missing(n, acc.buffer,
                                            acc.mapped_region(chunk), task,
                                            cmd, new_cmds)
            return
        self._emit_collective(task, buf, coll, needs, exec_cmds, new_cmds)

    def _classify_exchange(self, buf: VirtualBuffer,
                           needs: dict[int, Region]) -> Optional[dict]:
        """Classify the missing-data transfer matrix of one buffer.

        * ``allgather`` — >=2 single-owner pieces, every group member needs
          every piece it does not own (the replicated-exchange pattern);
        * ``broadcast`` — one source, >=2 destinations, identical region;
        * ``scatter`` — one source, >=2 destinations, pairwise-disjoint
          regions;
        * ``None`` — irregular / partial overlap: point-to-point path.
        """
        own = self._ownership_map(buf)
        srcmap: dict[int, dict[int, Region]] = {}
        for n, need in needs.items():
            for sub, owner in own.query(need):
                if owner is None:
                    continue  # uninitialized — TDAG already warned
                owners = (owner if isinstance(owner, frozenset)
                          else frozenset([owner]))
                if n in owners:
                    continue
                src = min(owners)
                dmap = srcmap.setdefault(src, {})
                dmap[n] = dmap.get(n, Region.empty()).union(sub)
        if not srcmap:
            return None
        sources = sorted(srcmap)
        dests = sorted({d for dmap in srcmap.values() for d in dmap})
        if len(sources) >= 2:
            group = tuple(sorted(set(sources) | set(dests)))
            blocks: dict[int, Region] = {}
            for s in sources:
                dmap = srcmap[s]
                if set(dmap) != set(group) - {s}:
                    return None
                regs = list(dmap.values())
                if any(r != regs[0] for r in regs[1:]):
                    return None
                blocks[s] = regs[0]
            return dict(kind="allgather", group=group, blocks=blocks,
                        root=None)
        s = sources[0]
        dmap = srcmap[s]
        if len(dmap) < 2:
            return None
        group = (s,) + tuple(sorted(dmap))
        regs = list(dmap.values())
        if all(r == regs[0] for r in regs[1:]):
            return dict(kind="broadcast", group=group, blocks={s: regs[0]},
                        root=s)
        ds = sorted(dmap)
        if all(not dmap[ds[i]].overlaps(dmap[ds[j]])
               for i in range(len(ds)) for j in range(i + 1, len(ds))):
            return dict(kind="scatter", group=group, blocks=dict(dmap),
                        root=s)
        return None

    def _emit_collective(self, task: Task, buf: VirtualBuffer, coll: dict,
                         needs: dict[int, Region],
                         exec_cmds: dict[int, Command],
                         new_cmds: list[Command]) -> None:
        kind, group, blocks, root = (coll["kind"], coll["group"],
                                     coll["blocks"], coll["root"])
        rounds = schedule_for(kind, group, contributors=tuple(sorted(blocks)),
                              root=root)
        ctype = {"allgather": CommandType.COLL_ALLGATHER,
                 "broadcast": CommandType.COLL_BROADCAST,
                 "scatter": CommandType.COLL_SCATTER}[kind]
        base_tid = (task.tid, buf.bid, 2)
        full_payload = Region.empty()
        for r in blocks.values():
            full_payload = full_payload.union(r)
        for n in group:
            if kind == "allgather":
                own_region = blocks.get(n, Region.empty())
            else:
                own_region = full_payload if n == root else Region.empty()
            recv_region = Region.empty()
            for msgs in rounds:
                for m in msgs:
                    if m.dst == n:
                        for b in m.blocks:
                            recv_region = recv_region.union(blocks[b])
            cmd = Command(ctype, node=n, task=task, buffer=buf,
                          region=own_region.union(recv_region),
                          transfer_id=base_tid, coll_group=group,
                          coll_blocks=blocks, coll_root=root)
            nst = self._node_buf(n, buf)
            if not own_region.is_empty():
                for sub, writer in nst.last_writers.query(own_region):
                    cmd.add_dependency(writer, DepKind.TRUE)
                nst.last_readers.append((own_region, cmd))
            if not recv_region.is_empty():
                # landing overwrites stale local data
                for sub, writer in nst.last_writers.query(recv_region):
                    cmd.add_dependency(writer, DepKind.ANTI)
                for rreg, reader in nst.last_readers:
                    if reader is not cmd and rreg.overlaps(recv_region):
                        cmd.add_dependency(reader, DepKind.ANTI)
                nst.last_writers.update(recv_region, cmd)
            if self._last_horizon[n] is not None:
                cmd.add_dependency(self._last_horizon[n], DepKind.SYNC)
            elif not cmd.dependencies and self._last_epoch[n] is not None:
                cmd.add_dependency(self._last_epoch[n], DepKind.SYNC)
            self._add(n, cmd)
            new_cmds.append(cmd)
            if n in needs:
                exec_cmds[n].add_dependency(cmd, DepKind.TRUE)
        # replicated ownership: every rank that lands a block (consumers AND
        # tree forwarders — both really hold the bytes) becomes up to date
        own = self._ownership_map(buf)
        for b, reg in blocks.items():
            receivers = {m.dst for msgs in rounds for m in msgs
                         if b in m.blocks}
            for sub, owner in own.query(reg):
                owners = (owner if isinstance(owner, frozenset)
                          else frozenset([owner]))
                own.update(sub, owners | receivers)

    # -- fused reduction exchange (DESIGN.md §9) --------------------------
    @staticmethod
    def _order_free(task: Task) -> bool:
        """Whether ALL of a task's reductions have an order-free combine
        (the reduce-scatter fold tree is not the canonical node order)."""
        return all(r.op.combine_order_free for r in task.reductions)

    def _queue_reductions(self, task: Task, node_chunks: dict[int, Box],
                          exec_cmds: dict[int, Command],
                          new_cmds: list[Command]) -> None:
        """Emit per-participant REDUCE_PARTIALs now; defer the exchange and
        the folds into the open fusion group (flushed when the chain
        breaks).  All reductions of one task always share the exchange."""
        participants = tuple(sorted(node_chunks))
        if self._open_red is None:
            self._open_red = dict(participants=participants, members=[],
                                  order_free=self._order_free(task))
        arx = self.allreduce and self._open_red["order_free"]
        for red in task.reductions:
            buf = red.buffer
            self._ownership_map(buf)               # register buffer
            rtid = (task.tid, buf.bid, 1)
            partials: dict[int, Command] = {}
            for n in participants:
                pc = Command(CommandType.REDUCE_PARTIAL, node=n, task=task,
                             buffer=buf, reduction=red,
                             region=buf.full_region, transfer_id=rtid,
                             participants=participants,
                             coll_group=tuple(range(self.num_nodes)),
                             collective=True, allreduce=arx)
                pc.add_dependency(exec_cmds[n], DepKind.TRUE)
                self._add(n, pc)
                new_cmds.append(pc)
                partials[n] = pc
            self._open_red["members"].append(
                dict(task=task, red=red, rtid=rtid, partials=partials))

    def _flush_reductions(self) -> list[Command]:
        """Emit the deferred exchange (one packed allgather for the whole
        fusion group) plus every member's REDUCE_GLOBAL fold."""
        group = self._open_red
        if group is None:
            return []
        self._open_red = None
        out: list[Command] = []
        members = group["members"]
        participants = group["participants"]
        arx = self.allreduce and group["order_free"]
        allnodes = tuple(range(self.num_nodes))
        first = members[0]
        base_tid = (first["task"].tid, first["red"].buffer.bid, 3)
        coll_members = tuple((m["rtid"], m["red"]) for m in members)
        ag_cmds: dict[int, Command] = {}
        if self.num_nodes > 1:
            xtype = (CommandType.COLL_ALLREDUCE if arx
                     else CommandType.COLL_ALLGATHER)
            for n in allnodes:
                ag = Command(xtype, node=n,
                             task=first["task"], buffer=first["red"].buffer,
                             reduction=first["red"], transfer_id=base_tid,
                             participants=participants, coll_group=allnodes,
                             coll_members=coll_members, collective=True,
                             allreduce=arx)
                for m in members:
                    pc = m["partials"].get(n)
                    if pc is not None:
                        ag.add_dependency(pc, DepKind.TRUE)
                if self._last_horizon[n] is not None:
                    ag.add_dependency(self._last_horizon[n], DepKind.SYNC)
                elif not ag.dependencies and self._last_epoch[n] is not None:
                    ag.add_dependency(self._last_epoch[n], DepKind.SYNC)
                self._add(n, ag)
                out.append(ag)
                ag_cmds[n] = ag
        for m in members:
            task, red, rtid = m["task"], m["red"], m["rtid"]
            buf = red.buffer
            full = buf.full_region
            global_cmds = {
                n: Command(CommandType.REDUCE_GLOBAL, node=n, task=task,
                           buffer=buf, reduction=red, region=full,
                           transfer_id=rtid, participants=participants,
                           coll_group=allnodes, collective=True,
                           allreduce=arx)
                for n in allnodes}
            if red.include_current_value:
                self._fetch_missing_grouped(task, buf,
                                            {n: full for n in allnodes},
                                            global_cmds, out)
            for n in allnodes:
                gc = global_cmds[n]
                nst = self._node_buf(n, buf)
                kind = (DepKind.TRUE if red.include_current_value
                        else DepKind.ANTI)
                for sub, writer in nst.last_writers.query(full):
                    gc.add_dependency(writer, kind)
                for rreg, reader in nst.last_readers:
                    gc.add_dependency(reader, DepKind.ANTI)
                if n in m["partials"]:
                    gc.add_dependency(m["partials"][n], DepKind.TRUE)
                if n in ag_cmds:
                    gc.add_dependency(ag_cmds[n], DepKind.TRUE)
                if self._last_horizon[n] is not None:
                    gc.add_dependency(self._last_horizon[n], DepKind.SYNC)
                elif not gc.dependencies and self._last_epoch[n] is not None:
                    gc.add_dependency(self._last_epoch[n], DepKind.SYNC)
                nst.last_writers.update(full, gc)
                nst.last_readers = []
                self._add(n, gc)
                out.append(gc)
            # the combined value is replicated on every node
            self._ownership_map(buf).update(full,
                                            frozenset(range(self.num_nodes)))
        return out

    # -- reductions ------------------------------------------------------
    def _process_reduction(self, task: Task, red: Reduction,
                           node_chunks: dict[int, Box],
                           exec_cmds: dict[int, Command],
                           new_cmds: list[Command]) -> None:
        """Emit per-node REDUCE_PARTIAL + replicated REDUCE_GLOBAL commands.

        The reduction dataflow intentionally violates the one-writer rule:
        every participating node produces a partial for the SAME full-buffer
        region, and every node (participating or not) writes the combined
        result.  Determinism holds because all nodes fold the partials in
        canonical node order and the replicated CDAG assigns identical
        participant sets everywhere.
        """
        buf = red.buffer
        self._ownership_map(buf)                   # register buffer
        rtid = (task.tid, buf.bid, 1)
        participants = tuple(sorted(node_chunks))
        full = buf.full_region

        # phase 1: command objects (no state reads yet)
        partial_cmds: dict[int, Command] = {}
        global_cmds: dict[int, Command] = {}
        for n in participants:
            pc = Command(CommandType.REDUCE_PARTIAL, node=n, task=task,
                         buffer=buf, reduction=red, region=full,
                         transfer_id=rtid, participants=participants,
                         targets=tuple(t for t in range(self.num_nodes)
                                       if t != n))
            pc.add_dependency(exec_cmds[n], DepKind.TRUE)
            partial_cmds[n] = pc
        for n in range(self.num_nodes):
            global_cmds[n] = Command(
                CommandType.REDUCE_GLOBAL, node=n, task=task, buffer=buf,
                reduction=red, region=full, transfer_id=rtid,
                participants=participants)

        # phase 2: include_current_value consumes the previous contents on
        # every node — fetch stale regions BEFORE the result overwrites them
        if red.include_current_value:
            for n in range(self.num_nodes):
                self._fetch_missing(n, buf, full, task, global_cmds[n],
                                    new_cmds)

        # phase 3: local deps + per-node state updates
        for n in range(self.num_nodes):
            gc = global_cmds[n]
            nst = self._node_buf(n, buf)
            kind = (DepKind.TRUE if red.include_current_value
                    else DepKind.ANTI)
            for sub, writer in nst.last_writers.query(full):
                gc.add_dependency(writer, kind)
            for rreg, reader in nst.last_readers:
                gc.add_dependency(reader, DepKind.ANTI)
            if n in partial_cmds:
                pc = partial_cmds[n]
                self._add(n, pc)
                new_cmds.append(pc)
                gc.add_dependency(pc, DepKind.TRUE)
            if self._last_horizon[n] is not None:
                gc.add_dependency(self._last_horizon[n], DepKind.SYNC)
            elif not gc.dependencies and self._last_epoch[n] is not None:
                gc.add_dependency(self._last_epoch[n], DepKind.SYNC)
            nst.last_writers.update(full, gc)
            nst.last_readers = []
            self._add(n, gc)
            new_cmds.append(gc)

        # the combined value is replicated on every node
        self._ownership_map(buf).update(full, frozenset(range(self.num_nodes)))


def generate_cdag(tdag: TaskGraph, num_nodes: int, *,
                  collectives: bool = False,
                  allreduce: bool = True) -> CommandGraphGenerator:
    gen = CommandGraphGenerator(num_nodes, collectives=collectives,
                                allreduce=allreduce)
    for task in tdag.tasks:
        if task.name == "init" and task.ttype == TaskType.EPOCH:
            continue
        gen.process(task)
    # a trailing open fusion group (stream ended without a sync) still
    # needs its exchange: flush it into the per-node command lists
    gen._flush_reductions()
    return gen
