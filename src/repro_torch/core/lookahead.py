# Copied from src/repro/core/lookahead.py.
"""Scheduler lookahead and resize elision (paper §4.3).

Commands are generated eagerly, but instruction-graph generation is
heuristically postponed while changing memory-allocation patterns are
observed:

* a freshly generated command is queried with ``would_allocate`` (cheap
  region query) and marked *allocating* if compiling it now would emit an
  ``alloc`` instruction;
* as long as no allocating command is queued, commands pass straight
  through;
* once an allocating command is queued, the queue holds until **two
  horizons** pass with no further allocating command (or an epoch forces a
  flush) — indicative of the task chain reaching an allocation steady state;
* on flush, every queued command's allocation requirements are merged into
  per-(buffer, memory) *widening hints* so the first ``alloc`` already covers
  everything observed in the window — eliding the resize chains of fig. 3.

The RSim growing-row pattern keeps re-arming the heuristic, so its whole
command graph is queued before the first instruction is emitted — exactly
the behaviour the paper reports (§4.3, fig. 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .command_graph import Command, CommandType
from .instruction_graph import IdagGenerator, Instruction
from .region import Region


@dataclass
class LookaheadStats:
    commands_seen: int = 0
    commands_queued_peak: int = 0
    flushes: int = 0
    allocating_commands: int = 0


class LookaheadScheduler:
    """Command queue between CDAG generation and IDAG compilation."""

    def __init__(self, idag: IdagGenerator, *, enabled: bool = True,
                 horizon_flush: int = 2, retire_compiled: bool = False,
                 metrics=None, tracer=None):
        self.idag = idag
        self.enabled = enabled
        self.horizon_flush = horizon_flush
        # observability (DESIGN.md §11): window occupancy sampled as a
        # counter track whenever the held-back queue changes size
        self.metrics = metrics
        self.tracer = tracer
        self._depth_metric = f"lookahead.N{idag.node}.queued"
        # ``retire_compiled`` (runtime mode): clear a command's dependency
        # lists once it is lowered, so retired CDAG prefixes are not kept
        # alive through inter-command edges (O(window) scheduler memory).
        # Structural tests that inspect command graphs leave this off.
        self.retire_compiled = retire_compiled
        self.queue: list[Command] = []
        self._horizons_since_alloc = 0
        self._have_allocating = False
        # requirements of already-queued commands: compiling a new command
        # "right away" means compiling it *after* the queued window, so a
        # requirement covered by the pending window is not newly allocating.
        self._pending: dict[tuple[int, int], Region] = {}
        self.stats = LookaheadStats()

    # ------------------------------------------------------------------
    def _compile(self, cmd: Command) -> list[Instruction]:
        out = self.idag.compile(cmd)
        if self.retire_compiled:
            # the command is fully lowered; its backward edges are no longer
            # consulted — clearing them breaks the reference chain that
            # would keep retired CDAG prefixes alive.  Dependents stay: the
            # sync frontier scan (`not c.dependents`) relies on them to add
            # SYNC edges only to graph leaves, and forward references die
            # with the command when its window is trimmed.
            cmd.dependencies.clear()
        return out

    # ------------------------------------------------------------------
    def _is_allocating(self, cmd: Command) -> bool:
        # REDUCE_PARTIAL only touches one-shot scratch (never widened);
        # REDUCE_GLOBAL writes the buffer's host backing and participates,
        # as do region collectives (their landing/staging region lives in
        # the buffer's pinned-host backing)
        if cmd.ctype not in (CommandType.EXECUTION, CommandType.PUSH,
                             CommandType.AWAIT_PUSH,
                             CommandType.REDUCE_GLOBAL,
                             CommandType.COLL_ALLGATHER,
                             CommandType.COLL_BROADCAST,
                             CommandType.COLL_SCATTER):
            return False
        out = False
        for (bid, mid), region in self.idag.allocation_requirements(cmd).items():
            bb = region.bounding_box()
            covered = not self.idag.would_allocate_box(bid, mid, bb)
            pend = self._pending.get((bid, mid))
            if not covered and pend is not None:
                covered = pend.bounding_box().contains(bb)
            if not covered:
                out = True
            key = (bid, mid)
            self._pending[key] = self._pending.get(key, Region.empty()).union(region)
        return out

    def push(self, cmd: Command) -> list[Instruction]:
        """Feed one command; returns any instructions that became ready."""
        self.stats.commands_seen += 1
        if not self.enabled:
            return self._compile(cmd)

        allocating = self._is_allocating(cmd)
        if allocating:
            self.stats.allocating_commands += 1

        if not self._have_allocating and not allocating:
            # steady state: pass through immediately (no latency added)
            return self._compile(cmd)

        self.queue.append(cmd)
        self.stats.commands_queued_peak = max(self.stats.commands_queued_peak,
                                              len(self.queue))
        self._sample_depth()
        if allocating:
            self._have_allocating = True
            self._horizons_since_alloc = 0
        elif cmd.ctype == CommandType.HORIZON:
            self._horizons_since_alloc += 1
            if self._horizons_since_alloc >= self.horizon_flush:
                return self.flush()
        if cmd.ctype == CommandType.EPOCH:
            return self.flush()   # user synchronization: cannot hold back
        return []

    # ------------------------------------------------------------------
    def flush(self) -> list[Instruction]:
        """Compile all queued commands with widened allocation hints.

        The merged window requirements go to the memory layer as
        *reservations* (``MemoryManager.reserve``): they widen the first
        ``alloc`` to cover everything observed — eliding the fig.-3 resize
        chains — AND protect those regions from budget eviction, so the
        lookahead and the eviction policy cooperate instead of fighting
        (evicting a region the window is about to touch would guarantee a
        spill/reload round-trip).
        """
        if not self.queue:
            return []
        self.stats.flushes += 1
        # merge allocation requirements of the whole window into hints;
        # the widening hints accumulate across flushes, but only THIS
        # window's requirements become eviction-protection reservations
        hints: dict[tuple[int, int], Region] = dict(self.idag.mem.hints)
        window: dict[tuple[int, int], Region] = {}
        for cmd in self.queue:
            for key, region in self.idag.allocation_requirements(cmd).items():
                hints[key] = hints.get(key, Region.empty()).union(region)
                window[key] = window.get(key, Region.empty()).union(region)
        self.idag.mem.reserve(hints, window=window)
        out: list[Instruction] = []
        # spill-aware reload prefetch: the window's spilled device regions
        # start their copy back BEFORE the commands that first touch them
        # compile, hiding reload latency behind the preceding execution
        out.extend(self.idag.mem.prefetch_reloads(window))
        for cmd in self.queue:
            out.extend(self._compile(cmd))
        self.queue.clear()
        self._pending.clear()
        self._have_allocating = False
        self._horizons_since_alloc = 0
        self._sample_depth()
        return out

    def _sample_depth(self) -> None:
        """Lookahead window occupancy (scheduler-lag time series)."""
        if self.metrics is None and self.tracer is None:
            return
        depth = float(len(self.queue))
        if self.metrics is not None:
            self.metrics.gauge(self._depth_metric, depth)
        if self.tracer is not None:
            self.tracer.counter(self._depth_metric, depth)
