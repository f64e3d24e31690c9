# Copied from src/repro/core/memory.py.
"""Memory management as a first-class layer (paper §3.2/§4.3 + budgets).

The :class:`MemoryManager` owns the complete allocation lifecycle that used
to be buried inside ``IdagGenerator``:

* the live backing allocations per (buffer, memory) and the resize-chain
  machinery of fig. 3 (merge-with-overlapping + lookahead widening hints);
* the per-(buffer, memory) producer/reader maps (``MemState``) — the
  anti-dependency bookkeeping that gives every allocation a *last user*;
* the coherence map (which memories hold an up-to-date replica of each
  buffer region);
* per-memory **byte budgets** with an LRU eviction policy: when a new
  allocation would exceed a memory's budget, victim allocations are
  *spilled* — their only-here coherent regions are copied down the chain
  device → pinned host (→ user host under pinned pressure) with ``SPILL``
  instructions, the victim is freed, and the next access to the evicted
  region lazily copies it back with a ``RELOAD`` instruction (the ordinary
  coherence machinery, tagged for accounting).

The ``IdagGenerator`` is a pure consumer: it requests regions
(:meth:`ensure`, :meth:`make_coherent`, :meth:`scratch`) and receives
placements; it never decides *where* bytes live or *what* gets dropped.

Budget-correctness invariants (see DESIGN.md §8):

* eviction happens **before** the ALLOC that caused the pressure is
  emitted, and every ALLOC in a budgeted memory takes anti-dependencies on
  all FREEs emitted in that memory since the last horizon/epoch — so the
  executor can never materialize the new allocation before the evicted
  bytes are actually released (cross-window ordering is covered by the
  ALLOC's sync dependency on the horizon);
* allocations pinned by the command currently being compiled, one-shot
  scratches (``evictable=False``) and — preferentially — allocations
  overlapping lookahead *reservations* are not selected as victims;
* eviction never fails: if no victim is available the manager goes over
  budget, records the event and appends a warning (a real system would
  rather thrash than crash).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from .allocation import (Allocation, PINNED_HOST, USER_HOST,
                         is_device_memory, queue_for_mem)
from .buffer import VirtualBuffer
from .instructions import Instruction, InstructionType
from .region import Box, Region, RegionMap
from .task_graph import DepKind


@dataclass
class MemState:
    """Per (buffer, memory) instruction-level tracking.

    ``producers`` maps each region to the instruction that last wrote it in
    this memory; ``readers`` lists (region, instruction) pairs of everything
    that read it since.  Together they are the lifetime information the
    eviction policy relies on: a FREE is anti-ordered after all of them.
    """
    producers: RegionMap          # region -> original producer Instruction
    readers: list[tuple[Region, Instruction]] = field(default_factory=list)


@dataclass
class MemoryStats:
    """Spill/eviction accounting, exposed via ``Runtime.memory_report()``."""
    evictions: int = 0            # victim allocations freed under pressure
    spills: int = 0               # SPILL copy instructions emitted
    spill_bytes: int = 0
    reloads: int = 0              # RELOAD copy instructions emitted
    reload_bytes: int = 0
    over_budget: int = 0          # pressure events with no evictable victim
    # write-back elision: evicted regions whose replica survives elsewhere
    # are dropped without a device->host SPILL copy.  ``writeback_elisions``
    # counts evictions that needed NO spill copy at all (fully clean
    # victim); ``elided_bytes`` counts every dropped-clean byte.
    writeback_elisions: int = 0
    elided_bytes: int = 0
    # reloads issued ahead of first use by the lookahead flush (§4.3)
    prefetched_reloads: int = 0
    # allocation renaming (DESIGN.md §13)
    renames: int = 0              # writes redirected to a fresh physical
    pool_hits: int = 0            # renames served from the recycled pool
    pool_frees: int = 0           # pooled physicals drained under pressure

    def as_dict(self) -> dict:
        return dict(evictions=self.evictions, spills=self.spills,
                    spill_bytes=self.spill_bytes, reloads=self.reloads,
                    reload_bytes=self.reload_bytes,
                    over_budget=self.over_budget,
                    writeback_elisions=self.writeback_elisions,
                    elided_bytes=self.elided_bytes,
                    prefetched_reloads=self.prefetched_reloads,
                    renames=self.renames, pool_hits=self.pool_hits,
                    pool_frees=self.pool_frees)


class MemoryManager:
    """Budgeted allocation lifecycle for one node's instruction graph.

    ``host`` is the owning ``IdagGenerator``; the manager emits its
    ALLOC/FREE/COPY/SPILL/RELOAD instructions through ``host._emit`` so
    emission order, counters and retirement behave exactly as before the
    extraction.  With no budgets configured the emitted instruction stream
    is bit-identical to the historical in-generator implementation.
    """

    def __init__(self, host, *, d2d: bool = True,
                 budgets: Optional[dict[int, int]] = None,
                 hints: Optional[dict[tuple[int, int], Region]] = None,
                 metrics=None, namespace: Optional[str] = None,
                 buffer_owner: Optional[dict[int, str]] = None,
                 renaming: bool = False):
        self.host = host
        self.d2d = d2d
        # allocation renaming (DESIGN.md §13): pure overwrites retire the
        # current physical to a per-(memory, size-class) free pool and bind
        # the buffer version to a fresh physical, turning WAR/WAW hazards
        # into pool recycling.  Off by default: the renamed stream trades
        # peak memory (two physicals per hot buffer) for pipeline depth.
        self.renaming = renaming
        # free pool: (mid, box.min, box.max, dtype) -> recycled physicals.
        # Exact-box matching keeps the executor's lazy offset slicing valid
        # with zero copies; ``_pool_allocs`` is the drain/shutdown index.
        self._free_pool: dict[tuple, list[Allocation]] = {}
        self._pool_allocs: list[Allocation] = []
        # multi-tenant serving (DESIGN.md §12): managers of different
        # tenants share one process but must never alias buffers.
        # ``namespace`` scopes the metric prefix; ``buffer_owner`` is the
        # serving runtime's shared bid -> tenant map consulted on
        # registration so a program that smuggles another tenant's buffer
        # handle is rejected at lowering time, not at data corruption time.
        self.namespace = namespace
        self.buffer_owner = buffer_owner
        # observability (DESIGN.md §11): pressure events mirrored into the
        # unified registry under ``memory.N<node>.*`` (namespace-scoped to
        # ``memory.<ns>.N<node>.*`` for serving tenants)
        self.metrics = metrics
        ns = f"{namespace}." if namespace else ""
        self._metric_prefix = f"memory.{ns}N{getattr(host, 'node', 0)}."
        self.budgets: dict[int, int] = dict(budgets or {})
        if USER_HOST in self.budgets:
            raise ValueError(
                "M0 (user host) memory cannot be budgeted: it is user-owned "
                "and the final target of every spill chain")
        # allocation state (was IdagGenerator._allocs/_mem/_coherence/_buffers)
        self.allocations: dict[tuple[int, int], list[Allocation]] = {}
        self.mem: dict[tuple[int, int], MemState] = {}
        self.coherence: dict[int, RegionMap] = {}       # region -> frozenset(mids)
        self.buffers: dict[int, VirtualBuffer] = {}
        # lookahead cooperation: ``hints`` accumulate for allocation widening
        # (fig.-3 resize elision needs the whole history); ``reserved`` is
        # the CURRENT lookahead window's requirements only — the regions
        # about to be accessed, which eviction avoids.  Protecting the
        # accumulated set instead would degenerate to plain LRU once every
        # buffer has been hinted at least once.
        self.hints: dict[tuple[int, int], Region] = dict(hints or {})
        self.reserved: dict[tuple[int, int], Region] = dict(self.hints)
        # budget accounting (compile-time model, bytes)
        self.used: dict[int, int] = {}
        self.peak: dict[int, int] = {}
        self.stats = MemoryStats()
        # buffer regions whose device replica was dropped by eviction; the
        # next coherence copy back into a device memory is tagged RELOAD
        self.spilled: dict[int, Region] = {}
        # FREEs emitted per budgeted memory since the last sync — every new
        # ALLOC in that memory anti-depends on them (runtime ordering)
        self._free_anchor: dict[int, list[Instruction]] = {}
        # over-budget warning dedup per memory id (the node is fixed per
        # manager): warning-list index + repeat count, so long over-budget
        # runs keep ``Runtime.warnings`` bounded like everything else
        self._over_budget_warned: dict[int, tuple[int, int]] = {}
        # pin scope: allocations touched while compiling the current command
        self._pins: set[int] = set()
        self._pin_depth = 0
        self._clock = 0
        # the initial epoch instruction; set by the generator right after it
        # is emitted (default producer for fresh MemStates)
        self.init_anchor: Optional[Instruction] = None

    # -- small helpers -----------------------------------------------------
    def _touch(self, a: Allocation) -> None:
        self._clock += 1
        a.last_use = self._clock
        if self._pin_depth:
            self._pins.add(a.aid)

    @contextmanager
    def pin_scope(self):
        """Protect every allocation touched inside the scope from eviction.

        Scopes nest (spilling re-enters ``ensure`` for the spill target);
        pins clear when the outermost scope exits — i.e. per compiled
        command, which is exactly the working set that must stay resident.
        """
        self._pin_depth += 1
        try:
            yield
        finally:
            self._pin_depth -= 1
            if self._pin_depth == 0:
                self._pins.clear()

    def _charge(self, a: Allocation) -> None:
        n = self.used.get(a.mid, 0) + a.nbytes()
        self.used[a.mid] = n
        if n > self.peak.get(a.mid, 0):
            self.peak[a.mid] = n
        self._touch(a)

    def _release(self, a: Allocation, free_instr: Instruction) -> None:
        self.used[a.mid] = self.used.get(a.mid, 0) - a.nbytes()
        if a.mid in self.budgets:
            self._free_anchor.setdefault(a.mid, []).append(free_instr)

    # -- buffer / state registration --------------------------------------
    def register_buffer(self, buf: VirtualBuffer) -> None:
        if buf.bid in self.buffers:
            return
        if self.buffer_owner is not None and self.namespace is not None:
            owner = self.buffer_owner.get(buf.bid)
            if owner is not None and owner != self.namespace:
                raise PermissionError(
                    f"tenant '{self.namespace}' accessed buffer "
                    f"'{buf.name}' (B{buf.bid}) owned by tenant '{owner}'")
        self.buffers[buf.bid] = buf
        if buf.initial_value is not None:
            # data present in user host memory M0, produced by init epoch
            a = Allocation(mid=USER_HOST, bid=buf.bid, box=buf.full_box,
                           dtype=buf.dtype, evictable=False,
                           initial_data=buf.initial_value)
            self.allocations[(buf.bid, USER_HOST)] = [a]
            self.coherence[buf.bid] = RegionMap(buf.full_box,
                                                default=frozenset([USER_HOST]))
            ms = self.state(buf.bid, USER_HOST)
            ms.producers.update(buf.full_region, self.init_anchor)
        else:
            self.coherence[buf.bid] = RegionMap(buf.full_box, default=frozenset())

    def state(self, bid: int, mid: int) -> MemState:
        ms = self.mem.get((bid, mid))
        if ms is None:
            buf = self.buffers[bid]
            ms = MemState(producers=RegionMap(buf.full_box,
                                              default=self.init_anchor))
            self.mem[(bid, mid)] = ms
        return ms

    def coherent_region(self, bid: int, mid: int) -> Region:
        out = Region.empty()
        for r, mids in self.coherence[bid].entries:
            if mids and mid in mids:
                out = out.union(r)
        return out

    def note_write(self, bid: int, region: Region) -> None:
        """A kernel/reduce overwrote ``region`` — nothing to reload there."""
        sp = self.spilled.get(bid)
        if sp is not None and not sp.is_empty():
            self.spilled[bid] = sp.difference(region)

    # -- queries (lookahead / would_allocate) ------------------------------
    def would_allocate_box(self, bid: int, mid: int, box: Box) -> bool:
        for a in self.allocations.get((bid, mid), []):
            if a.live and a.box.contains(box):
                return False
        return True

    def live(self, bid: int, mid: int, box: Box) -> Allocation:
        """The live allocation containing ``box`` (must exist)."""
        for a in self.allocations.get((bid, mid), []):
            if a.live and a.box.contains(box):
                self._touch(a)
                return a
        raise AssertionError(f"no live allocation covers B{bid} M{mid} {box}")

    def reserve(self, hints: dict[tuple[int, int], Region],
                window: Optional[dict[tuple[int, int], Region]] = None) -> None:
        """Adopt ``hints`` (accumulated) for allocation widening and
        ``window`` (the current lookahead window's requirements only) as
        eviction-protection reservations; without ``window`` the full hint
        set is protected (direct callers outside the lookahead)."""
        self.hints = dict(hints)
        self.reserved = dict(hints if window is None else window)

    def prefetch_reloads(self,
                         window: dict[tuple[int, int], Region]) -> list[Instruction]:
        """Spill-aware lookahead (§4.3 + DESIGN.md §8): issue RELOAD copies
        for the window's spilled device regions AHEAD of their first use, so
        reload latency hides behind execution like every other copy.

        Called by the lookahead flush after :meth:`reserve` (the window is
        already eviction-protected, so the prefetched bytes stay resident)
        and BEFORE the window's commands compile — the later ``ensure`` /
        ``make_coherent`` calls then find the region already in flight.
        """
        out: list[Instruction] = []
        # capture EVERYTHING emitted (allocs, frees, cascade spills, copies)
        with self.host.capture_batch(out):
            for (bid, mid), region in window.items():
                if not is_device_memory(mid):
                    continue
                sp = self.spilled.get(bid)
                if sp is None or sp.is_empty():
                    continue
                need = sp.intersect(region)
                if need.is_empty():
                    continue
                buf = self.buffers.get(bid)
                if buf is None:
                    continue
                before = self.stats.reloads
                with self.pin_scope():
                    self.make_coherent(buf, mid, need)
                self.stats.prefetched_reloads += \
                    self.stats.reloads - before
        return out

    # -- instruction emission helpers --------------------------------------
    def _emit_alloc(self, alloc: Allocation, name: str) -> Instruction:
        gen = self.host
        instr = gen._emit(Instruction(
            InstructionType.ALLOC, node=gen.node,
            queue=queue_for_mem(alloc.mid), allocation=alloc, name=name,
            persistent=alloc.bid is not None))
        if gen._last_horizon is not None:
            instr.add_dependency(gen._last_horizon, DepKind.SYNC)
        elif gen._last_epoch is not None:
            instr.add_dependency(gen._last_epoch, DepKind.SYNC)
        if alloc.mid in self.budgets:
            # never materialize before the bytes we evicted are released
            for fr in self._free_anchor.get(alloc.mid, ()):
                instr.add_dependency(fr, DepKind.ANTI)
        alloc.alloc_instr = instr
        self._charge(alloc)
        return instr

    def _free_instruction(self, alloc: Allocation) -> Instruction:
        """Bare FREE emission; callers wire anti-deps, then retire it."""
        gen = self.host
        return gen._emit(Instruction(
            InstructionType.FREE, node=gen.node,
            queue=queue_for_mem(alloc.mid), allocation=alloc,
            name=f"free {alloc}"))

    def _emit_free(self, alloc: Allocation, ms: MemState) -> Instruction:
        """FREE anti-ordered after every reader/producer of the allocation."""
        fr = self._free_instruction(alloc)
        breg = Region.from_box(alloc.box)
        for r, reader in ms.readers:
            if r.overlaps(breg):
                fr.add_dependency(reader, DepKind.ANTI)
        for sub, producer in ms.producers.query(breg):
            fr.add_dependency(producer, DepKind.ANTI)
        alloc.live = False
        self._release(alloc, fr)
        return fr

    def _emit_copy(self, buf: VirtualBuffer, src: Allocation, dst: Allocation,
                   box: Box, producer: Instruction,
                   itype: InstructionType = InstructionType.COPY) -> Instruction:
        # copies between device memories run on the (src) device queue;
        # host<->device copies run on the device queue; host-host on host.
        gen = self.host
        q = queue_for_mem(dst.mid if is_device_memory(dst.mid) else src.mid)
        cp = gen._emit(Instruction(
            itype, node=gen.node, queue=q,
            src_alloc=src, dst_alloc=dst, copy_box=box,
            name=f"{itype.value} {buf.name} {box} M{src.mid}->M{dst.mid}"))
        cp.add_dependency(producer, DepKind.TRUE)
        for a in (src, dst):
            if a.alloc_instr is not None:
                cp.add_dependency(a.alloc_instr, DepKind.TRUE)
        # WAR/WAW against the destination region in dst memory
        dms = self.state(buf.bid, dst.mid)
        breg = Region.from_box(box)
        for r, reader in dms.readers:
            if r.overlaps(breg):
                cp.add_dependency(reader, DepKind.ANTI)
        for sub, w in dms.producers.query(breg):
            cp.add_dependency(w, DepKind.OUTPUT)
        dms.producers.update(breg, cp)
        # reading the source region
        sms = self.state(buf.bid, src.mid)
        sms.readers.append((breg, cp))
        self._touch(src)
        self._touch(dst)
        if itype is InstructionType.SPILL:
            self.stats.spills += 1
            self.stats.spill_bytes += box.volume() * buf.elem_bytes()
            if self.metrics is not None:
                self.metrics.counter(self._metric_prefix + "spills")
                self.metrics.counter(self._metric_prefix + "spill_bytes",
                                     box.volume() * buf.elem_bytes())
        elif itype is InstructionType.RELOAD:
            self.stats.reloads += 1
            self.stats.reload_bytes += box.volume() * buf.elem_bytes()
            if self.metrics is not None:
                self.metrics.counter(self._metric_prefix + "reloads")
                self.metrics.counter(self._metric_prefix + "reload_bytes",
                                     box.volume() * buf.elem_bytes())
        return cp

    # -- allocation management (§3.2) ---------------------------------------
    def ensure(self, buf: VirtualBuffer, mid: int, box: Box) -> Allocation:
        """Return a live allocation whose box contains ``box``; emit
        alloc/copy/free resize chains if needed (fig. 3), evicting under
        budget pressure first."""
        self.register_buffer(buf)
        key = (buf.bid, mid)
        allocs = self.allocations.setdefault(key, [])
        for a in allocs:
            if a.live and a.box.contains(box):
                self._touch(a)
                return a
        # need a new allocation: merge with all overlapping live allocations
        # AND with lookahead widening hints, to a fixpoint — widening may
        # newly overlap allocations that the original request did not
        # (found by hypothesis, tests/test_lookahead_property.py)
        hint = self.hints.get(key)
        new_box = box
        while True:
            overlapping = [a for a in allocs
                           if a.live and a.box.overlaps(new_box)]
            grown = new_box
            for a in overlapping:
                grown = grown.union_bbox(a.box)
            if hint is not None and not hint.is_empty():
                for hb in hint.boxes:
                    if hb.overlaps(grown) or any(a.box.overlaps(hb)
                                                 for a in overlapping):
                        grown = grown.union_bbox(hb)
                hint_bb = hint.bounding_box()
                if hint_bb.overlaps(grown):
                    grown = grown.union_bbox(hint_bb)
            if grown == new_box:
                break
            new_box = grown
        new_alloc = Allocation(mid=mid, bid=buf.bid, box=new_box, dtype=buf.dtype)
        # budget pressure: make room BEFORE materializing; the overlapping
        # allocations must survive until their data migrates, so they are
        # protected (their bytes release when the migration frees them)
        self._evict_until(mid, new_alloc.nbytes(),
                          protect={a.aid for a in overlapping})
        self._emit_alloc(new_alloc, f"alloc {buf.name} M{mid} {new_box}")
        ms = self.state(buf.bid, mid)
        # migrate live data from the old allocations into the new one
        coherent_here = self.coherent_region(buf.bid, mid)
        for old in overlapping:
            live_region = coherent_here.intersect_box(old.box)
            for sub, producer in ms.producers.query(live_region):
                for b in sub.boxes:
                    self._emit_copy(buf, old, new_alloc, b, producer)
            self._emit_free(old, ms)
        self.allocations[key] = [a for a in allocs if a.live] + [new_alloc]
        # producers of migrated regions are now the copies — but since the
        # copies carry the same data, we keep the original producer mapping;
        # dependency-wise, subsequent readers in this memory must depend on
        # the migration copies, which we ensure by updating producers to them.
        return new_alloc

    def scratch(self, mid: int, box: Box, dtype, name: str) -> Allocation:
        """Emit a one-shot scratch ALLOC (outside the resize machinery),
        sync-anchored like every other allocation.  Scratches are charged
        against the budget but never selected as eviction victims — their
        lifetime is one reduction pipeline and they die on schedule."""
        alloc = Allocation(mid=mid, bid=None, box=box, dtype=dtype,
                           evictable=False)
        self._evict_until(mid, alloc.nbytes(), protect=frozenset())
        self._emit_alloc(alloc, name)
        return alloc

    def free_scratch(self, alloc: Allocation,
                     anti: list[Instruction]) -> Instruction:
        """Free a one-shot scratch once all ``anti`` users completed."""
        fr = self._free_instruction(alloc)
        for a in anti:
            fr.add_dependency(a, DepKind.ANTI)
        alloc.live = False
        self._release(alloc, fr)
        return fr

    # -- allocation renaming (DESIGN.md §13) --------------------------------
    @staticmethod
    def _pool_key(a: Allocation) -> tuple:
        return (a.mid, a.box.min, a.box.max, str(a.dtype))

    def rename_for_write(self, buf: VirtualBuffer, mid: int,
                         write_region: Region) -> Optional[Allocation]:
        """Redirect a pure overwrite of ``write_region`` to a fresh physical.

        The current physical backing the buffer version in ``mid`` retires
        to the free pool carrying its outstanding users as *hazard records*;
        the version map rebinds to a recycled (exact size-class match) or
        freshly allocated physical.  The writer then depends only on the new
        physical's hazards — for a fresh physical, on nothing at all — so
        WAR/WAW edges against the previous timestep's readers disappear from
        the emitted IDAG.  Returns the new physical, or ``None`` when
        renaming does not apply (not a device/pinned memory, no current
        physical, or dropping the physical would lose the sole coherent
        replica of a region the write does not cover).
        """
        if not self.renaming or mid == USER_HOST:
            return None
        key = (buf.bid, mid)
        bbox = write_region.bounding_box()
        cur = None
        for a in self.allocations.get(key, []):
            if a.live and a.box.contains(bbox):
                cur = a
                break
        if cur is None or cur.alloc_instr is None:
            return None
        breg = Region.from_box(cur.box)
        # hazard snapshot: everyone still using the old version through this
        # physical; the pool entry carries them until its next writer.  A
        # physical nobody uses (fresh ensure, no reads/writes yet) is NOT
        # renamed — the write carries no hazard edges to begin with, and a
        # pooled physical with an empty hazard list would let its drain-FREE
        # execute unordered against its own ALLOC.
        ms = self.state(buf.bid, mid)
        hz: list[Instruction] = []
        for r, reader in ms.readers:
            if r.overlaps(breg):
                hz.append(reader)
        for sub, producer in ms.producers.query(breg):
            if producer not in hz:
                hz.append(producer)
        if not hz:
            return None
        uncovered = breg.difference(write_region)
        coh = self.coherence[buf.bid]
        drops: list[tuple[Region, frozenset]] = []
        if not uncovered.is_empty():
            for sub, mids in coh.query(uncovered):
                if not mids or mid not in mids:
                    continue
                if mids == frozenset([mid]):
                    return None      # sole replica lives here: cannot drop
                drops.append((sub, mids))
        # recycle BEFORE retiring ``cur`` so we never hand it back to itself
        pkey = self._pool_key(cur)
        pool = self._free_pool.get(pkey)
        nxt = pool.pop() if pool else None
        for sub, mids in drops:
            coh.update(sub, mids - {mid})
        cur.hazards = hz
        cur.live = False
        cur.bid = None
        self.allocations[key] = \
            [a for a in self.allocations.get(key, []) if a is not cur]
        self._free_pool.setdefault(pkey, []).append(cur)
        self._pool_allocs.append(cur)
        if nxt is not None:
            self._pool_allocs.remove(nxt)
            nxt.bid = buf.bid
            nxt.live = True
            self._touch(nxt)
            self.stats.pool_hits += 1
        else:
            nxt = Allocation(mid=mid, bid=buf.bid, box=cur.box,
                             dtype=cur.dtype)
            self._evict_until(mid, nxt.nbytes(), protect=frozenset())
            self._emit_alloc(
                nxt, f"alloc {buf.name} M{mid} {cur.box} (rename)")
        # the old version's bookkeeping moves off the map: readers of the
        # retired physical live on only as its hazard records, and the
        # producer map re-anchors on the last sync point
        gen = self.host
        anchor = gen._last_horizon or gen._last_epoch or self.init_anchor
        ms.readers = [(r, t) for r, t in ms.readers if not r.overlaps(breg)]
        ms.producers.update(breg, anchor)
        self.allocations.setdefault(key, []).append(nxt)
        self.stats.renames += 1
        if self.metrics is not None:
            self.metrics.counter(self._metric_prefix + "renames")
        return nxt

    def take_hazards(self, alloc: Allocation) -> list[Instruction]:
        """Consume the hazard records of a recycled physical (the caller
        wires them as ANTI deps of the first new writer)."""
        hz = alloc.hazards
        if hz:
            alloc.hazards = []
        return hz

    def _drain_pool(self, mid: int) -> bool:
        """Free ONE pooled physical in ``mid`` to relieve budget pressure.

        Preference order cooperates with the lookahead: physicals whose box
        no reservation in this memory overlaps go first; reserved-size
        entries are drained only as a last resort (they would likely be
        re-allocated by the window's next rename)."""
        candidates = [a for a in self._pool_allocs if a.mid == mid]
        if not candidates:
            return False

        def wanted(a: Allocation) -> bool:
            areg = Region.from_box(a.box)
            for (bid, m), r in self.reserved.items():
                if m == mid and r is not None and not r.is_empty() \
                        and r.overlaps(areg):
                    return True
            return False

        victim = next((a for a in candidates if not wanted(a)),
                      candidates[0])
        fr = self._free_instruction(victim)
        if victim.alloc_instr is not None:
            fr.add_dependency(victim.alloc_instr, DepKind.TRUE)
        for h in victim.hazards:
            fr.add_dependency(h, DepKind.ANTI)
        victim.hazards = []
        self._release(victim, fr)
        self._pool_allocs.remove(victim)
        lst = self._free_pool.get(self._pool_key(victim))
        if lst and victim in lst:
            lst.remove(victim)
        self.stats.pool_frees += 1
        return True

    # -- eviction / spilling ------------------------------------------------
    def _evict_until(self, mid: int, need: int, protect: frozenset | set) -> None:
        budget = self.budgets.get(mid)
        if budget is None:
            return
        while self.used.get(mid, 0) + need > budget:
            # recycled-but-idle physicals are the cheapest bytes to reclaim:
            # no spill copy, no coherence loss — drain the pool first
            if self._drain_pool(mid):
                continue
            victim = self._pick_victim(mid, protect)
            if victim is None:
                self.stats.over_budget += 1
                msg = (f"memory M{mid} over budget on N{self.host.node}: "
                       f"{self.used.get(mid, 0)} bytes live + {need} "
                       f"requested > budget {budget}, nothing evictable")
                prev = self._over_budget_warned.get(mid)
                if prev is None:
                    # first occurrence for this (memory, node): new entry
                    self.host.warnings.append(msg)
                    self._over_budget_warned[mid] = \
                        (len(self.host.warnings) - 1, 1)
                else:
                    # repeat: update the entry in place with the latest
                    # numbers and a counter instead of growing the list
                    idx, count = prev
                    self.host.warnings[idx] = \
                        f"{msg} (repeated {count + 1} times)"
                    self._over_budget_warned[mid] = (idx, count + 1)
                return
            self._spill(victim)
            self.stats.evictions += 1
            if self.metrics is not None:
                self.metrics.counter(self._metric_prefix + "evictions")

    def _is_dirty(self, a: Allocation) -> bool:
        """Whether evicting ``a`` would need a write-back: some region of it
        is coherent ONLY here.  In this coherence model a write makes its
        memory the sole coherent holder, so clean <=> replica elsewhere."""
        coh = self.coherence.get(a.bid)
        if coh is None:
            return False
        for sub, mids in coh.query(Region.from_box(a.box)):
            if mids and mids == frozenset([a.mid]):
                return True
        return False

    def _pick_victim(self, mid: int, protect) -> Optional[Allocation]:
        """Victim scoring: reservations first (cooperate, don't fight §4.3),
        then clean-before-dirty (a clean victim's eviction elides the
        write-back copy entirely), then LRU."""
        best = None
        best_key = None
        for (bid, m), lst in self.allocations.items():
            if m != mid:
                continue
            res = self.reserved.get((bid, mid))
            for a in lst:
                if (not a.live or not a.evictable or a.aid in self._pins
                        or a.aid in protect):
                    continue
                reserved = bool(res is not None and not res.is_empty()
                                and res.overlaps(Region.from_box(a.box)))
                k = (reserved, self._is_dirty(a), a.last_use)
                if best_key is None or k < best_key:
                    best, best_key = a, k
        return best

    def _spill(self, victim: Allocation) -> None:
        """Evict one allocation: copy its only-here coherent regions down
        the spill chain (device -> pinned host -> user host), then free it.

        Regions also coherent in another memory are simply dropped (the
        replica survives); the device-resident regions lost here are marked
        so the next coherence copy back is tagged RELOAD.
        """
        bid, mid = victim.bid, victim.mid
        buf = self.buffers[bid]
        ms = self.state(bid, mid)
        coh = self.coherence[bid]
        vregion = Region.from_box(victim.box)
        only_here: list[Region] = []
        elsewhere: list[tuple[Region, frozenset]] = []
        spilled_out = Region.empty()
        for sub, mids in coh.query(vregion):
            if not mids or mid not in mids:
                continue
            if mids == frozenset([mid]):
                only_here.append(sub)
                # only regions actually copied out count as spilled — a
                # dropped replica survives elsewhere, so copying it back
                # later is ordinary coherence traffic, not a RELOAD
                spilled_out = spilled_out.union(sub)
            else:
                elsewhere.append((sub, mids))
                # write-back elision: the region is clean here (a coherent
                # replica survives elsewhere), so dropping it needs no copy
                self.stats.elided_bytes += \
                    sum(b.volume() for b in sub.boxes) * buf.elem_bytes()
        if not only_here:
            self.stats.writeback_elisions += 1
        target_mid = PINNED_HOST if is_device_memory(mid) else USER_HOST
        if only_here:
            out = Region.empty()
            for sub in only_here:
                out = out.union(sub)
            # the spill target may itself come under pressure -> cascades
            dst = self.ensure(buf, target_mid, out.bounding_box())
            for sub in only_here:
                for psub, producer in ms.producers.query(sub):
                    for b in psub.boxes:
                        self._emit_copy(buf, victim, dst, b, producer,
                                        itype=InstructionType.SPILL)
                coh.update(sub, frozenset([target_mid]))
        for sub, mids in elsewhere:
            coh.update(sub, mids - {mid})
        if is_device_memory(mid) and not spilled_out.is_empty():
            sp = self.spilled.get(bid, Region.empty())
            self.spilled[bid] = sp.union(spilled_out)
        self._emit_free(victim, ms)
        self.allocations[(bid, mid)] = \
            [a for a in self.allocations.get((bid, mid), []) if a is not victim]

    # -- coherence (§3.3) ----------------------------------------------------
    def make_coherent(self, buf: VirtualBuffer, mid: int,
                      region: Region) -> list[Instruction]:
        """Emit producer-split copies so ``region`` is up-to-date in ``mid``.
        Copies of previously evicted regions back into device memory are
        tagged RELOAD (lazy reload-on-next-access)."""
        self.register_buffer(buf)
        copies: list[Instruction] = []
        coh = self.coherence[buf.bid]
        stale = Region.empty()
        for sub, mids in coh.query(region):
            if not mids or mid in mids:
                continue
            stale = stale.union(sub)
        if stale.is_empty():
            return copies
        dst = self.ensure(buf, mid, region.bounding_box())
        sp = self.spilled.get(buf.bid)
        track_reload = (is_device_memory(mid) and sp is not None
                        and not sp.is_empty())
        for sub, mids in coh.query(stale):
            if not mids:
                continue
            src_mid = self._pick_source(mids, mid)
            if (is_device_memory(src_mid) and is_device_memory(mid)
                    and not self.d2d):
                # no P2P: stage through pinned host memory (§3.3)
                copies += self.make_coherent(buf, PINNED_HOST, sub)
                src_mid = PINNED_HOST
            src_ms = self.state(buf.bid, src_mid)
            itype = (InstructionType.RELOAD
                     if track_reload and sp.overlaps(sub)
                     else InstructionType.COPY)
            for src_alloc in self.allocations.get((buf.bid, src_mid), []):
                if not src_alloc.live:
                    continue
                part = sub.intersect_box(src_alloc.box)
                # producer split: one copy per original-producer entry
                for psub, producer in src_ms.producers.query(part):
                    for b in psub.boxes:
                        copies.append(self._emit_copy(buf, src_alloc, dst, b,
                                                      producer, itype=itype))
            coh.update(sub, (frozenset(mids) | {mid}))
        if track_reload:
            self.spilled[buf.bid] = sp.difference(stale)
        return copies

    def _pick_source(self, mids: frozenset, target: int) -> int:
        """Prefer same-kind memory, then pinned host, then user host."""
        mids = set(mids)
        if is_device_memory(target):
            dev = [m for m in mids if is_device_memory(m)]
            if dev and self.d2d:
                return min(dev)
            if PINNED_HOST in mids:
                return PINNED_HOST
            if USER_HOST in mids:
                return USER_HOST
            return min(mids)
        for pref in (PINNED_HOST, USER_HOST):
            if pref in mids:
                return pref
        return min(mids)

    # -- sync integration ----------------------------------------------------
    def compact_at_sync(self, sync_instr: Instruction) -> None:
        """Horizon compaction: prior producers collapse onto the sync point;
        the free-anchor lists reset (the ALLOC sync dependency now covers
        runtime ordering against everything before the horizon)."""
        for ms in self.mem.values():
            ms.producers.update(ms.producers.covered(), sync_instr)
            ms.producers.coalesce()
            ms.readers = []
        self._free_anchor.clear()
        # pooled physicals' hazards collapse onto the sync too — NOT to
        # empty: an instruction compiled after this sync that has other
        # dependencies gets no sync edge of its own, so a recycled
        # physical's first writer must still order behind the sync here
        for a in self._pool_allocs:
            a.hazards = [sync_instr]

    # -- shutdown -------------------------------------------------------------
    def free_all(self) -> list[Instruction]:
        """Emit frees for all live allocations (buffer destruction, §3.2)."""
        out = []
        for (bid, mid), allocs in self.allocations.items():
            for a in allocs:
                if not a.live or mid == USER_HOST:
                    continue
                out.append(self._emit_free(a, self.state(bid, mid)))
        for a in self._pool_allocs:
            fr = self._free_instruction(a)
            if a.alloc_instr is not None:
                fr.add_dependency(a.alloc_instr, DepKind.TRUE)
            for h in a.hazards:
                fr.add_dependency(h, DepKind.ANTI)
            a.hazards = []
            self._release(a, fr)
            out.append(fr)
        self._pool_allocs.clear()
        self._free_pool.clear()
        return out

    def pool_provenance(self) -> list[dict]:
        """Free-pool state for the schedule sanitizer (DESIGN.md §14).

        One record per currently pooled (retired, recyclable) physical:
        its identity, its size-class pool key, the ALLOC instruction that
        materialized it, and the iids of the hazard records its next writer
        must consume as ANTI deps.  The verifier cross-checks these against
        the captured instruction stream — a pooled physical whose hazards
        were dropped is exactly the PR 9 drain-FREE bug shape.
        """
        return [dict(aid=a.aid, mid=a.mid, key=self._pool_key(a),
                     alloc_iid=(a.alloc_instr.iid
                                if a.alloc_instr is not None else None),
                     hazard_iids=[h.iid for h in a.hazards],
                     nbytes=a.nbytes())
                for a in self._pool_allocs]

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        """Compile-time model state for benchmarks/diagnostics."""
        return dict(budgets=dict(self.budgets), used=dict(self.used),
                    peak=dict(self.peak), **self.stats.as_dict())
