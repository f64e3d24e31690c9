# Copied from src/repro/core/task_graph.py.
"""Task graph (TDAG) generation — paper §2.3/§2.4, horizons per §3.5.

Each task represents a cluster-collective operation (usually a kernel).  The
TDAG is generated identically on all nodes; dependencies are computed at
buffer-element granularity as if the program executed on a single device.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .buffer import Accessor, AccessMode, VirtualBuffer
from .reduction import Reduction
from .region import Box, Region, RegionMap


class TaskType(enum.Enum):
    KERNEL = "kernel"          # device kernel (data-parallel over index space)
    HOST = "host"              # host task (runs in a host thread)
    EPOCH = "epoch"            # graph-based synchronization with main thread
    HORIZON = "horizon"        # tracking-complexity bound / pruning point


class DepKind(enum.Enum):
    TRUE = "true"        # read-after-write (dataflow)
    ANTI = "anti"        # write-after-read
    OUTPUT = "output"    # write-after-write
    SYNC = "sync"        # epoch/horizon graph-synchronization


_task_ids = itertools.count()


@dataclass
class Task:
    ttype: TaskType
    name: str = ""
    index_space: Optional[Box] = None            # kernel tasks only
    accessors: tuple[Accessor, ...] = ()
    reductions: tuple[Reduction, ...] = ()        # reduction outputs (§2.2)
    kernel_fn: Optional[Callable] = None          # (arrays..., chunk) -> outputs
    split_dims: tuple[int, ...] = (0,)            # user hint: split axes
    granularity: tuple[int, ...] = (1,)           # split alignment hint
    tid: int = field(default_factory=lambda: next(_task_ids))
    dependencies: list[tuple["Task", DepKind]] = field(default_factory=list)
    dependents: list["Task"] = field(default_factory=list)
    critical_path: int = 0
    # reduction-fusion chain marker (DESIGN.md §9): stamped by the TDAG on
    # the MAIN thread, so the decision is replicated by construction — the
    # CDAG may merge this task's reduction exchange with the immediately
    # preceding reduction task's exchange (same horizon window, no
    # dependency path between them).
    fuse_with_prev: bool = False

    def add_dependency(self, dep: "Task", kind: DepKind) -> None:
        if dep is self:
            return
        for d, _ in self.dependencies:
            if d is dep:
                return
        self.dependencies.append((dep, kind))
        dep.dependents.append(self)
        self.critical_path = max(self.critical_path, dep.critical_path + 1)

    def __hash__(self) -> int:
        return self.tid

    def __repr__(self) -> str:
        return f"T{self.tid}<{self.ttype.value}:{self.name}>"


@dataclass
class _BufferState:
    """Per-buffer tracking for TDAG dependency generation."""
    last_writers: RegionMap                     # Region -> Task
    last_readers: list[tuple[Region, Task]] = field(default_factory=list)
    initialized: Region = field(default_factory=Region.empty)
    # replicated-pending: the last write was a reduction whose (replicated)
    # result every node will hold once the producing task executes — readers
    # take a TRUE dep on it but the CDAG will never generate pushes for it
    pending_reduction: Optional[Task] = None


class TaskGraph:
    """Generates the TDAG from a stream of submissions.

    Horizon tasks are emitted when the maximum critical-path length grows by
    ``horizon_step`` since the last horizon (Thoman et al. [23]); the horizon
    then *replaces* all previous writers/readers as the dependency frontier,
    bounding tracking structures.
    """

    def __init__(self, horizon_step: int = 4, max_front_width: int = 16,
                 fuse_reductions: bool = True):
        self.tasks: list[Task] = []
        # reduction fusion scope (DESIGN.md §9): the task whose reduction
        # exchange is still "open" for fusion; any non-reduction kernel,
        # horizon/epoch, or dependency path breaks the chain
        self.fuse_reductions = fuse_reductions
        self._red_chain: list[Task] = []
        # prefix retirement (runtime mode): ``tasks[0]`` is lifetime index
        # ``_base``; ``retire_to`` drops broadcast prefixes at sync points so
        # TDAG memory is O(window) on long programs (DESIGN.md §3)
        self._base = 0
        self.horizon_step = horizon_step
        self.max_front_width = max_front_width
        self._buffers: dict[int, _BufferState] = {}
        self._buffer_objs: dict[int, VirtualBuffer] = {}
        self._last_horizon: Optional[Task] = None
        self._prev_horizon: Optional[Task] = None
        self._last_epoch: Optional[Task] = None
        self._cp_at_last_horizon = 0
        self._frontier_pos = 0          # index of the last sync task
        self.warnings: list[str] = []
        # initial epoch — everything hangs off it
        self._last_epoch = self._append(Task(TaskType.EPOCH, name="init"))

    # ------------------------------------------------------------------
    def _append(self, task: Task) -> Task:
        self.tasks.append(task)
        return task

    def _state(self, buf: VirtualBuffer) -> _BufferState:
        st = self._buffers.get(buf.bid)
        if st is None:
            st = _BufferState(last_writers=RegionMap(buf.full_box, default=self._last_epoch))
            if buf.initial_value is not None:
                st.initialized = buf.full_region
            self._buffers[buf.bid] = st
            self._buffer_objs[buf.bid] = buf
        return st

    # ------------------------------------------------------------------
    def submit(self, name: str, index_space: Box | Sequence[int],
               accessors: Sequence[Accessor], kernel_fn: Callable | None = None,
               ttype: TaskType = TaskType.KERNEL,
               split_dims: Sequence[int] = (0,),
               granularity: Sequence[int] = (1,)) -> Task:
        """Submit a command group; returns the created task.

        ``accessors`` may mix :class:`Accessor` and :class:`Reduction`
        descriptors — kernels bind reduction outputs exactly like accessors.
        """
        if not isinstance(index_space, Box):
            index_space = Box.full(tuple(index_space))
        plain = tuple(a for a in accessors if isinstance(a, Accessor))
        reds = tuple(r for r in accessors if isinstance(r, Reduction))
        if len({r.buffer.bid for r in reds}) != len(reds):
            # would collide on the (task, buffer) reduction transfer id
            raise ValueError(f"task {name!r} binds multiple reductions to "
                             f"the same buffer")
        task = Task(ttype, name=name, index_space=index_space,
                    accessors=plain, reductions=reds, kernel_fn=kernel_fn,
                    split_dims=tuple(split_dims), granularity=tuple(granularity))

        for acc in task.accessors:
            st = self._state(acc.buffer)
            region = acc.mapped_region(index_space)
            if acc.mode.is_consumer:
                # uninitialized-read detection (paper §4.4)
                produced = Region.empty()
                for r, _ in st.last_writers.entries:
                    produced = produced.union(r)
                known = st.initialized.union(self._written_region(st))
                missing = region.difference(known)
                if not missing.is_empty():
                    self.warnings.append(
                        f"uninitialized read of {acc.buffer.name} region {missing} in task {name}")
                # true dependencies on last writers
                for sub, writer in st.last_writers.query(region):
                    task.add_dependency(writer, DepKind.TRUE)
                st.last_readers.append((region, task))
            if acc.mode.is_producer:
                # anti-deps on readers of the overwritten region
                for rregion, reader in st.last_readers:
                    if rregion.overlaps(region):
                        task.add_dependency(reader, DepKind.ANTI)
                # output deps on previous writers
                for sub, writer in st.last_writers.query(region):
                    task.add_dependency(writer, DepKind.OUTPUT)
                st.last_writers.update(region, task)
                st.last_readers = [(r, t) for r, t in st.last_readers
                                   if not r.difference(region).is_empty()]
                # any overwrite breaks the pure replicated-pending state
                st.pending_reduction = None

        # reduction outputs: a true-dependency write of the WHOLE buffer on
        # every node at once (N partial producers -> 1 replicated value);
        # with include_current_value the previous contents are consumed too
        for red in task.reductions:
            st = self._state(red.buffer)
            full = red.buffer.full_region
            if red.include_current_value:
                known = st.initialized.union(self._written_region(st))
                missing = full.difference(known)
                if not missing.is_empty():
                    self.warnings.append(
                        f"uninitialized read of {red.buffer.name} region "
                        f"{missing} in reduction of task {name}")
            for rregion, reader in st.last_readers:
                task.add_dependency(reader, DepKind.ANTI)
            for sub, writer in st.last_writers.query(full):
                task.add_dependency(writer,
                                    DepKind.TRUE if red.include_current_value
                                    else DepKind.OUTPUT)
            st.last_writers.update(full, task)
            st.last_readers = []
            st.initialized = full
            st.pending_reduction = task

        if not task.dependencies and self._last_epoch is not None:
            task.add_dependency(self._last_epoch, DepKind.SYNC)
        if self._last_horizon is not None:
            task.add_dependency(self._last_horizon, DepKind.SYNC)

        # reduction-fusion chain (DESIGN.md §9): decided HERE, on the main
        # thread, from replicated TDAG state only — every node scheduler
        # sees the same ``fuse_with_prev`` stamps, so the fused exchange
        # topology is identical everywhere.  A task extends the chain iff it
        # has reductions and no dependency path to any open chain member
        # (a path would make the fused exchange cyclic: the earlier member's
        # result would wait on a partial that waits on the result).
        if reds and self.fuse_reductions:
            if self._red_chain and not self._reaches_any(task, self._red_chain):
                task.fuse_with_prev = True
                self._red_chain.append(task)
            else:
                self._red_chain = [task]
        elif ttype in (TaskType.KERNEL, TaskType.HOST):
            self._red_chain = []          # adjacency broken

        self._append(task)
        self._maybe_emit_horizon(task)
        return task

    def _reaches_any(self, task: Task, targets: list[Task]) -> bool:
        """Transitive dependency check bounded to the open-chain window."""
        lo = targets[0].tid
        target_ids = {t.tid for t in targets}
        stack = [task]
        seen: set[int] = set()
        while stack:
            for dep, _ in stack.pop().dependencies:
                if dep.tid in target_ids:
                    return True
                if dep.tid >= lo and dep.tid not in seen:
                    seen.add(dep.tid)
                    stack.append(dep)
        return False

    def _written_region(self, st: _BufferState) -> Region:
        out = Region.empty()
        for r, v in st.last_writers.entries:
            if isinstance(v, Task) and v.ttype in (TaskType.KERNEL, TaskType.HOST,
                                                   TaskType.HORIZON, TaskType.EPOCH):
                if v.ttype in (TaskType.KERNEL, TaskType.HOST) or v.name != "init":
                    out = out.union(r)
        return out

    # ------------------------------------------------------------------
    def _maybe_emit_horizon(self, task: Task) -> None:
        front = [t for t in self.tasks[-(self.max_front_width * 4):]
                 if not t.dependents and t.ttype == TaskType.KERNEL]
        if (task.critical_path - self._cp_at_last_horizon >= self.horizon_step
                or len(front) >= self.max_front_width):
            self.emit_horizon()

    def emit_horizon(self) -> Task:
        horizon = Task(TaskType.HORIZON, name=f"H@cp{self.tasks[-1].critical_path}")
        # horizon depends on the current execution front; tasks before the
        # previous sync already have a dependent (that sync), so scan the tail
        for t in self.tasks[self._frontier_pos:]:
            if not t.dependents and t is not horizon:
                horizon.add_dependency(t, DepKind.SYNC)
        self._append(horizon)
        self._frontier_pos = len(self.tasks) - 1
        # horizon becomes the new frontier: substitute it for all prior
        # writers/readers so tracking structures stay bounded [23]
        for st in self._buffers.values():
            st.last_writers.update(st.last_writers.covered(), horizon)
            st.last_writers.coalesce()
            st.last_readers = [(r, t) for r, t in st.last_readers
                               if t.critical_path >= horizon.critical_path - self.horizon_step]
        self._prev_horizon, self._last_horizon = self._last_horizon, horizon
        self._cp_at_last_horizon = horizon.critical_path
        self._red_chain = []              # fusion scope ends at the horizon
        return horizon

    def emit_epoch(self, name: str = "epoch") -> Task:
        epoch = Task(TaskType.EPOCH, name=name)
        for t in self.tasks[self._frontier_pos:]:
            if not t.dependents and t is not epoch:
                epoch.add_dependency(t, DepKind.SYNC)
        self._append(epoch)
        self._frontier_pos = len(self.tasks) - 1
        for st in self._buffers.values():
            st.last_writers.update(st.last_writers.covered(), epoch)
            st.last_writers.coalesce()
            st.last_readers = []
        self._last_epoch = epoch
        self._last_horizon = None
        # the epoch compacted every tracking structure — it is a pruning
        # point at least as strong as a horizon, so the horizon cadence
        # restarts here (otherwise a horizon can fire one task after the
        # epoch, and horizon placement depends on cross-epoch phase)
        self._cp_at_last_horizon = epoch.critical_path
        self._red_chain = []              # fusion scope ends at the epoch
        return epoch

    # ------------------------------------------------------------------
    @property
    def task_count(self) -> int:
        """Lifetime number of tasks ever submitted (incl. retired ones)."""
        return self._base + len(self.tasks)

    def retire_to(self, lifetime_idx: int) -> int:
        """Drop the task-list prefix below ``lifetime_idx``, bounded by the
        last sync point (everything before it is transitively dominated by
        that sync and all internal tracking maps were compacted onto it).

        Retired tasks get their dependency lists cleared, breaking the
        reference chain that would otherwise keep the whole task history
        alive through horizon edges.  Callers must only pass indices of
        tasks that every consumer (node scheduler) has already received —
        the CDAG never reads task graph edges, so clearing is safe even if
        a scheduler has not *processed* the task yet.  Returns the number
        of tasks dropped.
        """
        cut = min(lifetime_idx - self._base, self._frontier_pos)
        if cut <= 0:
            return 0
        for t in self.tasks[:cut]:
            t.dependencies.clear()
            t.dependents.clear()
        del self.tasks[:cut]
        self._base += cut
        self._frontier_pos -= cut
        return cut

    # ------------------------------------------------------------------
    def kernel_tasks(self) -> list[Task]:
        return [t for t in self.tasks if t.ttype in (TaskType.KERNEL, TaskType.HOST)]

    def pending_reductions(self) -> dict[int, Task]:
        """Buffers whose last write is a replicated-pending reduction."""
        return {bid: st.pending_reduction for bid, st in self._buffers.items()
                if st.pending_reduction is not None}
