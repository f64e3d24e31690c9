# Copied from src/repro/core/verify.py.
"""Schedule sanitizer: static verification of lowered instruction graphs.

Every hazard the runtime must respect is an explicit edge in the IDAG, so
race freedom, lifetime safety, communication matching, deadlock freedom and
the compile-time budget model are all decidable by pure graph analysis —
before, or concurrently with, execution (DESIGN.md §14).

The verifier consumes *snapshots* of instruction windows taken at submit
time (the executor rebinds ``dependencies`` when it retires instructions,
so the dependency lists must be copied before submission).  Four check
families run over the snapshots:

``race``
    Every conflicting access pair (at least one producer, overlapping
    regions, same allocation) must be ordered by a happens-before path.
    Reachability is computed with per-partition bitsets (Python ints), so
    the pair check is one AND.  Reduction ("red") accesses are mutually
    exempt — the one-writer exception for commutative accumulation.
``lifetime``
    Accesses fall inside their allocation's [ALLOC, FREE] interval on a
    happens-before path; no double-free; no free-before-alloc; every
    scratch ALLOC is balanced by a FREE (leak detection).  The check
    naturally covers recycled free-pool physicals: renaming reuses the
    *same* ``Allocation`` object, so hazard wiring between lives is
    verified as ordinary same-allocation conflict ordering.
``comm``
    Per-node streams are merged on transfer ids: every push SEND matches
    exactly one RECEIVE/SPLIT_RECEIVE whose region contains the sent box,
    gather SENDs match GATHER_RECEIVE source slots 1:1, COLL_SEND /
    COLL_RECV pair 1:1 per (transfer id, source, dest) with equal fragment
    key sets, pilots biject with sends, and the merged graph plus
    send→receive wait edges is acyclic (Kahn; a residual cycle is reported
    with its member instructions).
``budget``
    An emission-order replay of ALLOC/FREE byte deltas must reproduce the
    peak the compile-time :class:`MemoryManager` model promised, and a
    FREE emitted before an ALLOC in the same budgeted memory must be on a
    happens-before path to it (the eager-reuse ordering PR 9's drain bug
    violated).

Partitioning: streams are split at sync instructions (every instruction
happens-before the next HORIZON/EPOCH because sync collects the whole
undominated frontier, and every later instruction happens-after it through
the producer re-anchoring at compaction), so cross-partition pairs are
ordered by construction and only intra-partition pairs need bitsets.

A verifier that passes vacuously is worse than none, so this module also
ships the mutation self-test harness (:func:`mutate_one`,
:func:`run_mutation_campaign`): a seeded fuzzer plants exactly one defect
in a known-good graph — deleted/retargeted dependency edge, unbalanced
ALLOC/FREE, duplicated FREE, dropped collective fragment key, retargeted
send, dropped pilot — and the campaign asserts the sanitizer reports it
*and* names the mutated instruction.
"""

from __future__ import annotations

import random
import threading
import time
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from .instructions import Instruction, InstructionType, Pilot
from .region import Region
from .task_graph import DepKind

_IT = InstructionType
_RECV_TYPES = (_IT.RECEIVE, _IT.SPLIT_RECEIVE)
_SYNC_TYPES = (_IT.HORIZON, _IT.EPOCH)


def _conflict(m1: str, m2: str) -> bool:
    """Two access modes conflict unless both read or both reduce."""
    if m1 == "r" and m2 == "r":
        return False
    if m1 == "red" and m2 == "red":
        return False
    return True


@dataclass(frozen=True)
class VerificationIssue:
    """One invariant violation, naming the instructions involved."""

    kind: str                     # race | lifetime | leak | comm | deadlock | budget
    node: Optional[int]           # node the defect was observed on (None: cross-node)
    instrs: tuple[int, ...]       # iids of the instructions involved
    detail: str

    def __str__(self) -> str:
        where = f"N{self.node}" if self.node is not None else "cross-node"
        who = ",".join(f"I{i}" for i in self.instrs) or "-"
        return f"[{self.kind}] {where} {who}: {self.detail}"


@dataclass
class VerificationReport:
    """Aggregate result of a verification pass."""

    issues: list[VerificationIssue] = field(default_factory=list)
    instructions: int = 0
    windows: int = 0
    pairs_checked: int = 0
    elapsed_us: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.issues

    def check(self) -> None:
        if self.issues:
            raise VerificationError(self.issues)


class VerificationError(RuntimeError):
    """Raised when verification finds invariant violations."""

    def __init__(self, issues: Sequence[VerificationIssue]):
        self.issues = list(issues)
        head = "; ".join(str(i) for i in self.issues[:3])
        more = f" (+{len(self.issues) - 3} more)" if len(self.issues) > 3 else ""
        super().__init__(
            f"schedule verification failed, {len(self.issues)} issue(s): {head}{more}")


class _Snap:
    """Submit-time snapshot of one instruction (deps copied before submit)."""

    __slots__ = ("instr", "deps", "_acc")

    def __init__(self, instr: Instruction):
        self.instr = instr
        self.deps = [(d.iid, k) for d, k in instr.dependencies]
        self._acc = None

    def accesses(self):
        if self._acc is None:
            self._acc = self.instr.accesses()
        return self._acc

    def __repr__(self):
        return f"snap({self.instr!r})"


class ScheduleVerifier:
    """Incremental verifier over captured instruction windows.

    ``mode="final"`` runs every check family at :meth:`finalize` (called at
    each sync point), partitioned at sync boundaries so reachability
    bitsets stay small.  ``mode="window"`` additionally runs the bitset
    race/lifetime check per submitted window, concurrently with its
    execution, on a dedicated verifier worker thread (the scheduler thread
    only pays for the capture — finalize barriers on the worker); finalize
    covers the linear cross-window lifetime checks plus comm/deadlock/
    budget.  Window mode
    does not check cross-window races within one sync partition — that gap
    is closed by final mode and documented in DESIGN.md §14.

    Captured snapshots pin instructions (and their closures) for the run's
    lifetime, which defeats executor-side retirement; verification is a
    debugging/CI configuration, not a production default.
    """

    def __init__(self, num_nodes: int, *, mode: str = "final",
                 metrics=None, budgets: Optional[dict] = None):
        if mode not in ("final", "window"):
            raise ValueError(f"verify mode must be 'final' or 'window', got {mode!r}")
        self.num_nodes = num_nodes
        self.mode = mode
        self.metrics = metrics
        self.budgets = dict(budgets or {})
        self._lock = threading.Lock()
        self.streams: list[list[_Snap]] = [[] for _ in range(num_nodes)]
        self.pilots: list[Pilot] = []
        self.issues: list[VerificationIssue] = []
        self.windows = 0
        self.pairs_checked = 0
        # persistent per-node lifetime / budget state (advanced at finalize)
        self._cursor = [0] * num_nodes
        self._pilot_cursor = 0
        self._alloc_seen: list[dict] = [dict() for _ in range(num_nodes)]
        self._freed: list[dict] = [dict() for _ in range(num_nodes)]
        self._used: list[dict] = [dict() for _ in range(num_nodes)]
        self._replay_peak: list[dict] = [dict() for _ in range(num_nodes)]
        # window mode: checks run on a dedicated worker thread so the
        # scheduler thread only pays for the capture — otherwise the next
        # window's lowering serializes behind the previous window's
        # verification and the check lands on the issue critical path.  The
        # worker is event-driven over per-node cursors (set() on an already
        # -set Event is a flag check, so a burst of windows costs one wake)
        self._wv_event: Optional[threading.Event] = None
        self._wv_cursor = [0] * num_nodes
        self._wv_flush: list[threading.Event] = []
        if mode == "window":
            self._wv_event = threading.Event()
            threading.Thread(target=self._window_worker,
                             name="verify-window", daemon=True).start()

    # ---------------------------------------------------------------- capture

    def capture(self, node: int, instrs: Sequence[Instruction]) -> tuple[int, int]:
        """Snapshot a window before it is handed to the executor."""
        with self._lock:
            stream = self.streams[node]
            lo = len(stream)
            stream.extend(_Snap(i) for i in instrs)
            self.windows += 1
            return (lo, len(stream))

    def capture_pilots(self, pilots: Iterable[Pilot]) -> None:
        with self._lock:
            self.pilots.extend(pilots)

    # ---------------------------------------------------------- window checks

    def verify_window(self, node: int, span: tuple[int, int]) -> None:
        """Mark one submitted window for race/lifetime checking (window
        mode).  Runs asynchronously on the verifier worker thread; issues
        surface at the next :meth:`finalize`/:meth:`check`."""
        if self._wv_event is not None:
            self._wv_event.set()
        else:
            self._verify_window_sync(node, span)

    def _window_worker(self) -> None:
        while True:
            self._wv_event.wait()
            self._wv_event.clear()
            with self._lock:
                spans = [(n, self._wv_cursor[n], len(self.streams[n]))
                         for n in range(self.num_nodes)]
                for n, _lo, hi in spans:
                    self._wv_cursor[n] = hi
                flush = self._wv_flush
                self._wv_flush = []
            for n, lo, hi in spans:
                if hi > lo:
                    # backlogged windows per node are contiguous in stream
                    # order, so checking the whole unverified range widens the
                    # partition — a superset of the pairs the individual
                    # per-window checks would cover
                    self._verify_window_sync(n, (lo, hi))
            for ev in flush:
                ev.set()

    def _flush_windows(self) -> None:
        """Wait until every captured window has been checked (finalize
        barrier)."""
        if self._wv_event is None:
            return
        done = threading.Event()
        with self._lock:
            self._wv_flush.append(done)
        self._wv_event.set()
        done.wait(timeout=120.0)

    def _verify_window_sync(self, node: int, span: tuple[int, int]) -> None:
        t0 = time.perf_counter()
        issues = self._span_hb_checks(node, span[0], span[1])
        self.issues.extend(issues)
        dt = (time.perf_counter() - t0) * 1e6
        if self.metrics is not None:
            self.metrics.observe("verify.window_us", dt)
            self.metrics.counter("verify.windows")
            if issues:
                self.metrics.counter("verify.issues", len(issues))

    # ------------------------------------------------------------- final pass

    def finalize(self, peaks: Optional[Sequence[dict]] = None) -> VerificationReport:
        """Verify everything captured since the previous finalize.

        ``peaks`` is the per-node compile-time peak model
        (``IdagGenerator.mem.peak``) to replay against; omit it when the
        captured stream is not charged to a fresh model (memo replay).
        """
        self._flush_windows()
        t0 = time.perf_counter()
        new: list[VerificationIssue] = []
        with self._lock:
            spans = [(n, self._cursor[n], len(self.streams[n]))
                     for n in range(self.num_nodes)]
            pilots = self.pilots[self._pilot_cursor:]
            self._pilot_cursor = len(self.pilots)
            for n, lo, hi in spans:
                self._cursor[n] = hi
        for n, lo, hi in spans:
            if self.mode == "final":
                new.extend(self._span_hb_checks(n, lo, hi))
            new.extend(self._lifetime_linear(n, lo, hi))
        if peaks is not None:
            new.extend(self._budget_compare(peaks))
        wait_edges = self._comm_matching(spans, pilots, new)
        new.extend(self._deadlock(spans, wait_edges))
        self.issues.extend(new)
        dt = (time.perf_counter() - t0) * 1e6
        if self.metrics is not None:
            self.metrics.observe("verify.final_us", dt)
            if new:
                self.metrics.counter("verify.issues", len(new))
        total = sum(len(s) for s in self.streams)
        return VerificationReport(issues=list(self.issues), instructions=total,
                                  windows=self.windows,
                                  pairs_checked=self.pairs_checked, elapsed_us=dt)

    def check(self) -> None:
        """Raise :class:`VerificationError` if any issue has been found."""
        if self.issues:
            raise VerificationError(self.issues)

    # ----------------------------------------------------- happens-before core

    @staticmethod
    def _reach(snaps: Sequence[_Snap]) -> tuple[dict, list[int]]:
        """Ancestor bitsets over one partition (deps point backwards)."""
        pos = {s.instr.iid: i for i, s in enumerate(snaps)}
        reach: list[int] = []
        for i, s in enumerate(snaps):
            r = 1 << i
            for diid, _k in s.deps:
                j = pos.get(diid)
                if j is not None and j < i:
                    r |= reach[j]
            reach.append(r)
        return pos, reach

    def _span_hb_checks(self, node: int, lo: int, hi: int) -> list[VerificationIssue]:
        """Race + intra-partition lifetime ordering over ``stream[lo:hi]``.

        Dependencies on instructions outside the span are treated as
        satisfied (they point at earlier partitions, which are ordered
        before everything here by the sync-barrier construction).
        """
        snaps = self.streams[node][lo:hi]
        if not snaps:
            return []
        issues: list[VerificationIssue] = []
        pos, reach = self._reach(snaps)
        bit = [1 << i for i in range(len(snaps))]

        def hb(a: int, b: int) -> bool:
            return bool(reach[b] & bit[a]) if a <= b else False

        # group accesses by allocation; an aid may have several [ALLOC, FREE]
        # *lives* within one span (memo replay re-opens template allocations
        # once per replayed window), so ALLOC/FREE indices are kept as lists
        by_alloc: dict[int, list] = {}
        allocs: dict[int, list[int]] = {}     # aid -> snap indices of ALLOCs
        frees: dict[int, list[int]] = {}      # aid -> snap indices of FREEs
        alloc_objs: dict[int, object] = {}
        for i, s in enumerate(snaps):
            it = s.instr.itype
            if it is _IT.ALLOC:
                allocs.setdefault(s.instr.allocation.aid, []).append(i)
                alloc_objs[s.instr.allocation.aid] = s.instr.allocation
            elif it is _IT.FREE:
                frees.setdefault(s.instr.allocation.aid, []).append(i)
                alloc_objs[s.instr.allocation.aid] = s.instr.allocation
            else:
                for a, reg, m in s.accesses():
                    by_alloc.setdefault(a.aid, []).append((i, reg, m))
                    alloc_objs[a.aid] = a

        # race freedom: conflicting overlapping pairs need a path.  Access
        # lists are in snap-index order, so for a pair (x, y) with x before
        # y only hb(x, y) can hold (deps point backwards) — one bitset AND,
        # checked before the (expensive) region-overlap test.  The only
        # non-conflicting mode pairs are r/r and red/red (the one-writer
        # reduction exception); everything else has a producer.
        pairs = 0
        for aid, accs in by_alloc.items():
            if len(accs) < 2:
                continue
            for y, (iy, ry, my) in enumerate(accs):
                benign = my if (my == "r" or my == "red") else None
                ry_overlaps = ry.overlaps
                reach_y = reach[iy]
                for ix, rx, mx in accs[:y]:
                    if ix == iy or mx == benign:
                        continue
                    pairs += 1
                    if reach_y & bit[ix]:
                        continue
                    if not ry_overlaps(rx):
                        continue
                    a, b = snaps[ix].instr, snaps[iy].instr
                    issues.append(VerificationIssue(
                        "race", node, (a.iid, b.iid),
                        f"unordered {mx}/{my} overlap on {alloc_objs[aid]!r}: "
                        f"{a!r} vs {b!r} — missing happens-before edge "
                        f"I{a.iid}->I{b.iid}"))
        self.pairs_checked += pairs

        # lifetime ordering within the partition: every access must be on a
        # path after the nearest preceding ALLOC of its aid and before the
        # nearest following FREE; consecutive lives must be serialized
        # (memo replay windows share template Allocation objects, so window
        # k+1's re-ALLOC must not overtake window k's FREE)
        for aid in set(by_alloc) | set(frees):
            al = allocs.get(aid, [])
            fl = frees.get(aid, [])
            for i, _reg, _m in by_alloc.get(aid, ()):
                j = bisect_right(al, i) - 1
                if j >= 0 and not hb(al[j], i):
                    issues.append(VerificationIssue(
                        "lifetime", node,
                        (snaps[al[j]].instr.iid, snaps[i].instr.iid),
                        f"access {snaps[i].instr!r} not ordered after ALLOC "
                        f"of {alloc_objs[aid]!r}"))
                j = bisect_left(fl, i)
                if j < len(fl) and not hb(i, fl[j]):
                    issues.append(VerificationIssue(
                        "lifetime", node,
                        (snaps[i].instr.iid, snaps[fl[j]].instr.iid),
                        f"use-after-free: {snaps[i].instr!r} not ordered "
                        f"before FREE of {alloc_objs[aid]!r}"))
            for fi in fl:
                j = bisect_right(al, fi) - 1
                if j >= 0 and not hb(al[j], fi):
                    issues.append(VerificationIssue(
                        "lifetime", node,
                        (snaps[al[j]].instr.iid, snaps[fi].instr.iid),
                        f"FREE not ordered after ALLOC of {alloc_objs[aid]!r}"))
            for ai in al:
                j = bisect_left(fl, ai) - 1
                if j >= 0 and not hb(fl[j], ai):
                    issues.append(VerificationIssue(
                        "lifetime", node,
                        (snaps[fl[j]].instr.iid, snaps[ai].instr.iid),
                        f"re-allocation {snaps[ai].instr!r} not ordered after "
                        f"previous life's FREE of {alloc_objs[aid]!r}"))

        # budget ordering: an eager-reuse FREE emitted before a later ALLOC in
        # the same budgeted memory must be on a path to it (else the model's
        # peak is a lie at runtime — the PR 9 drain-ordering bug shape)
        if self.budgets:
            free_by_mid: dict = {}
            for aid, fl in frees.items():
                mid = alloc_objs[aid].mid
                if mid in self.budgets:
                    free_by_mid.setdefault(mid, []).extend(fl)
            for aid, al in allocs.items():
                mid = alloc_objs[aid].mid
                for ai in al:
                    for fi in free_by_mid.get(mid, ()):
                        if fi < ai and not hb(fi, ai):
                            issues.append(VerificationIssue(
                                "budget", node,
                                (snaps[fi].instr.iid, snaps[ai].instr.iid),
                                f"eager reuse unordered: FREE "
                                f"{snaps[fi].instr!r} must happen-before "
                                f"ALLOC {snaps[ai].instr!r} in budgeted "
                                f"memory {mid}"))
        return issues

    # -------------------------------------------------- linear lifetime pass

    def _lifetime_linear(self, node: int, lo: int, hi: int) -> list[VerificationIssue]:
        """Cross-partition lifetime + budget replay (O(n), persistent maps).

        Emission order is a topological order, so life alternation is
        checkable linearly: an aid is *live* between ALLOC and FREE, may be
        re-opened by a later ALLOC (memo replay re-opens template
        allocations once per window — the hb ordering of re-opens is
        checked in :meth:`_span_hb_checks`), and any FREE or access while
        closed is a double-free / use-after-free no edge can repair (edges
        only point backwards).
        """
        issues: list[VerificationIssue] = []
        live = self._alloc_seen[node]     # aid -> (alloc_iid, persistent, a)
        closed = self._freed[node]        # aid -> iid of the FREE that closed it
        used = self._used[node]
        peak = self._replay_peak[node]
        for s in self.streams[node][lo:hi]:
            i = s.instr
            it = i.itype
            if it is _IT.ALLOC:
                a = i.allocation
                if a.aid in live:
                    issues.append(VerificationIssue(
                        "lifetime", node, (live[a.aid][0], i.iid),
                        f"duplicate ALLOC for live {a!r}"))
                closed.pop(a.aid, None)   # re-opened: a new life begins
                live[a.aid] = (i.iid, bool(i.persistent), a)
                used[a.mid] = used.get(a.mid, 0) + a.nbytes()
                if used[a.mid] > peak.get(a.mid, 0):
                    peak[a.mid] = used[a.mid]
            elif it is _IT.FREE:
                a = i.allocation
                if a.aid in live:
                    live.pop(a.aid)
                    closed[a.aid] = i.iid
                    used[a.mid] = used.get(a.mid, 0) - a.nbytes()
                elif a.aid in closed:
                    issues.append(VerificationIssue(
                        "lifetime", node, (closed[a.aid], i.iid),
                        f"double-free of {a!r}"))
                else:
                    issues.append(VerificationIssue(
                        "lifetime", node, (i.iid,),
                        f"FREE of never-allocated {a!r}"))
            else:
                for a, _reg, _m in s.accesses():
                    if a.aid in closed:
                        issues.append(VerificationIssue(
                            "lifetime", node, (closed[a.aid], i.iid),
                            f"use-after-free: {i!r} emitted after FREE of "
                            f"{a!r}"))
        # leak check: every scratch ALLOC must be balanced by now — scratch
        # lifetime never crosses a sync partition (plain Runtime) or a
        # drained window (serving replay)
        for aid in list(live):
            alloc_iid, persistent, a = live[aid]
            if not persistent:
                issues.append(VerificationIssue(
                    "leak", node, (alloc_iid,),
                    f"scratch {a!r} allocated but never freed"))
                live.pop(aid)            # report once
        return issues

    def _budget_compare(self, peaks: Sequence[dict]) -> list[VerificationIssue]:
        issues = []
        for n in range(self.num_nodes):
            promised = peaks[n] if n < len(peaks) else {}
            replay = self._replay_peak[n]
            for mid in sorted(set(promised) | set(replay), key=str):
                if promised.get(mid, 0) != replay.get(mid, 0):
                    issues.append(VerificationIssue(
                        "budget", n, (),
                        f"peak replay mismatch in {mid}: model promised "
                        f"{promised.get(mid, 0)}B, replay saw {replay.get(mid, 0)}B"))
        return issues

    # ------------------------------------------------------- comm + deadlock

    def _comm_matching(self, spans, pilots, out: list[VerificationIssue]):
        """Cross-node transfer matching; returns send→receive wait edges."""
        sends, gsends, csends = [], [], []
        recvs: dict = {}
        gathers, crecvs = [], {}
        for n, lo, hi in spans:
            for s in self.streams[n][lo:hi]:
                i = s.instr
                it = i.itype
                if it is _IT.SEND:
                    (gsends if len(i.transfer_id) == 3 else sends).append((n, s))
                elif it in _RECV_TYPES:
                    recvs.setdefault((n, i.transfer_id), []).append(s)
                elif it is _IT.GATHER_RECEIVE:
                    gathers.append((n, s))
                elif it is _IT.COLL_SEND:
                    csends.append((n, s))
                elif it is _IT.COLL_RECV:
                    key = (n, i.transfer_id, i.coll_source)
                    crecvs.setdefault(key, []).append(s)
        wait_edges: list[tuple[int, int]] = []
        matched_boxes: dict[int, list] = {}
        # all push sends per transfer id regardless of dest: when a receive
        # starves, the culprit is usually a send mis-aimed at another node,
        # so the issue names every send on the same tid for attribution
        sends_by_tid: dict = {}
        for n, s in sends:
            sends_by_tid.setdefault(s.instr.transfer_id, []).append(s.instr.iid)

        for n, s in sends:
            i = s.instr
            cands = recvs.get((i.dest, i.transfer_id), [])
            inside = [r for r in cands
                      if r.instr.recv_region.contains_box(i.send_box)]
            if len(inside) != 1:
                out.append(VerificationIssue(
                    "comm", n, (i.iid,),
                    f"push send {i!r} matches {len(inside)} receives on "
                    f"N{i.dest} for tid {i.transfer_id}"))
            else:
                r = inside[0]
                wait_edges.append((i.iid, r.instr.iid))
                matched_boxes.setdefault(id(r), []).append(i.send_box)
        for (n, tid), rlist in recvs.items():
            peers = tuple(sends_by_tid.get(tid, ()))
            for r in rlist:
                boxes = matched_boxes.get(id(r), [])
                if not boxes:
                    out.append(VerificationIssue(
                        "comm", n, (r.instr.iid,) + peers,
                        f"orphan receive {r.instr!r}: no send targets tid {tid}"))
                    continue
                landed = Region.empty()
                for b in boxes:
                    landed = landed.union(Region.from_box(b))
                if not r.instr.recv_region.difference(landed).is_empty():
                    out.append(VerificationIssue(
                        "comm", n, (r.instr.iid,) + peers,
                        f"receive {r.instr!r} region not covered by its sends "
                        f"— the executor would wait forever"))

        gmatched = set()
        for n, s in gathers:
            g = s.instr
            for src in g.gather_sources:
                related = [ss for sn, ss in gsends
                           if sn == src and ss.instr.transfer_id == g.transfer_id]
                hits = [(src, ss) for ss in related if ss.instr.dest == n]
                if len(hits) != 1:
                    out.append(VerificationIssue(
                        "comm", n,
                        (g.iid,) + tuple(ss.instr.iid for ss in related),
                        f"gather {g!r} expects exactly 1 partial from rank "
                        f"{src}, saw {len(hits)}"))
                for _sn, ss in hits:
                    gmatched.add(id(ss))
                    wait_edges.append((ss.instr.iid, g.iid))
        for n, s in gsends:
            if id(s) not in gmatched:
                out.append(VerificationIssue(
                    "comm", n, (s.instr.iid,),
                    f"gather send {s.instr!r} has no expecting GATHER_RECEIVE"))

        cmatched = set()
        for n, s in csends:
            i = s.instr
            rlist = crecvs.get((i.dest, i.transfer_id, n), [])
            if len(rlist) != 1:
                out.append(VerificationIssue(
                    "comm", n, (i.iid,),
                    f"collective send {i!r} matches {len(rlist)} COLL_RECVs "
                    f"on N{i.dest}"))
                continue
            r = rlist[0]
            cmatched.add(id(r))
            wait_edges.append((i.iid, r.instr.iid))
            sent = set(f.key for f in i.coll_frags)
            expect = set(r.instr.coll_expect)
            if sent != expect:
                out.append(VerificationIssue(
                    "comm", n, (i.iid, r.instr.iid),
                    f"fragment keys mismatch: {i!r} packs {sorted(map(str, sent))}"
                    f" but {r.instr!r} expects {sorted(map(str, expect))}"))
        for (n, tid, src), rlist in crecvs.items():
            for r in rlist:
                if id(r) not in cmatched:
                    out.append(VerificationIssue(
                        "comm", n, (r.instr.iid,),
                        f"orphan COLL_RECV {r.instr!r}: no COLL_SEND from "
                        f"N{src} for tid {tid}"))

        # pilots ↔ sends bijection on (source, transfer_id, msg_id)
        send_keys: dict = {}
        for n, s in sends + gsends + csends:
            send_keys.setdefault((n, s.instr.transfer_id, s.instr.msg_id),
                                 []).append(s)
        pilot_keys: dict = {}
        for p in pilots:
            pilot_keys.setdefault((p.source, p.transfer_id, p.msg_id),
                                  []).append(p)
        for key, plist in pilot_keys.items():
            hits = send_keys.get(key, [])
            if len(hits) != len(plist):
                out.append(VerificationIssue(
                    "comm", key[0], tuple(s.instr.iid for s in hits),
                    f"{len(plist)} pilot(s) for tid {key[1]} msg {key[2]} but "
                    f"{len(hits)} send(s)"))
        for key, slist in send_keys.items():
            if len(pilot_keys.get(key, [])) != len(slist):
                out.append(VerificationIssue(
                    "comm", key[0], tuple(s.instr.iid for s in slist),
                    f"send(s) for tid {key[1]} msg {key[2]} posted "
                    f"{len(pilot_keys.get(key, []))} pilot(s), expected "
                    f"{len(slist)}"))
        return wait_edges

    def _deadlock(self, spans, wait_edges) -> list[VerificationIssue]:
        """Kahn's algorithm over the merged chunk + wait edges.

        Fast path: emission order is a topological order for an honest
        stream, so if every in-chunk dependency points backwards and there
        are no cross-node wait edges, the chunk is acyclic by construction
        and the full Kahn pass is skipped (the single-node common case).
        """
        if not wait_edges:
            order: dict[int, int] = {}
            k = 0
            for n, lo, hi in spans:
                for s in self.streams[n][lo:hi]:
                    order[s.instr.iid] = k
                    k += 1
            if all(order.get(diid, -1) < order[s.instr.iid]
                   for n, lo, hi in spans
                   for s in self.streams[n][lo:hi]
                   for diid, _k in s.deps):
                return []
        snaps: dict[int, _Snap] = {}
        node_of: dict[int, int] = {}
        for n, lo, hi in spans:
            for s in self.streams[n][lo:hi]:
                snaps[s.instr.iid] = s
                node_of[s.instr.iid] = n
        preds: dict[int, list[int]] = {iid: [] for iid in snaps}
        succs: dict[int, list[int]] = {iid: [] for iid in snaps}
        for iid, s in snaps.items():
            for diid, _k in s.deps:
                if diid in snaps:
                    preds[iid].append(diid)
                    succs[diid].append(iid)
        for src, dst in wait_edges:
            if src in snaps and dst in snaps:
                preds[dst].append(src)
                succs[src].append(dst)
        indeg = {iid: len(p) for iid, p in preds.items()}
        queue = [iid for iid, d in indeg.items() if d == 0]
        done = 0
        while queue:
            iid = queue.pop()
            done += 1
            for t in succs[iid]:
                indeg[t] -= 1
                if indeg[t] == 0:
                    queue.append(t)
        if done == len(snaps):
            return []
        residual = {iid for iid, d in indeg.items() if d > 0}
        # walk predecessors inside the residual set until we revisit: a cycle
        path, seen_at = [], {}
        cur = next(iter(residual))
        while cur not in seen_at:
            seen_at[cur] = len(path)
            path.append(cur)
            cur = next(p for p in preds[cur] if p in residual)
        cycle = path[seen_at[cur]:]
        names = ", ".join(repr(snaps[i].instr) for i in cycle[:6])
        return [VerificationIssue(
            "deadlock", None, tuple(cycle),
            f"dependency/wait cycle of {len(cycle)} instruction(s): {names}")]


# ------------------------------------------------------------------ one-shot


def verify_graph(node_instrs: Sequence[Sequence[Instruction]], *,
                 pilots: Iterable[Pilot] = (),
                 budgets: Optional[dict] = None,
                 peaks: Optional[Sequence[dict]] = None) -> VerificationReport:
    """Verify fully-lowered (not yet executed) per-node instruction streams."""
    v = ScheduleVerifier(len(node_instrs), mode="final", budgets=budgets)
    for n, instrs in enumerate(node_instrs):
        v.capture(n, instrs)
    v.capture_pilots(list(pilots))
    return v.finalize(peaks=peaks)


# ------------------------------------------------------- mutation self-tests


@dataclass
class Mutation:
    """One planted defect; ``targets`` are the iids attribution must name."""

    op: str
    node: int
    targets: tuple[int, ...]
    detail: str


@dataclass
class MutantResult:
    mutation: Mutation
    detected: bool
    attributed: bool
    issues: tuple[VerificationIssue, ...]


@dataclass
class CampaignResult:
    results: list[MutantResult] = field(default_factory=list)
    skipped: int = 0

    @property
    def total(self) -> int:
        return len(self.results)

    @property
    def detected(self) -> int:
        return sum(1 for r in self.results if r.detected)

    @property
    def attributed(self) -> int:
        return sum(1 for r in self.results if r.attributed)

    def by_op(self) -> dict:
        out: dict = {}
        for r in self.results:
            d = out.setdefault(r.mutation.op, [0, 0])
            d[0] += 1
            d[1] += 1 if r.attributed else 0
        return out

    def misses(self) -> list[MutantResult]:
        return [r for r in self.results if not r.attributed]


def _edge_bearing(si: _Snap, sj: _Snap, budgets: Optional[dict]) -> bool:
    """Does edge ``si -> sj`` (si depends on sj) carry a checked invariant?"""
    ii, ij = si.instr, sj.instr
    if ij.itype is _IT.ALLOC:
        a = ij.allocation
        if ii.itype is _IT.FREE and ii.allocation is a:
            return True
        if any(al is a for al, _r, _m in si.accesses()):
            return True
    if ii.itype is _IT.FREE:
        a = ii.allocation
        if any(al is a for al, _r, _m in sj.accesses()):
            return True
    if (ij.itype is _IT.FREE and ii.itype is _IT.ALLOC and budgets
            and ii.allocation.mid == ij.allocation.mid
            and ii.allocation.mid in budgets):
        return True
    for a1, r1, m1 in si.accesses():
        for a2, r2, m2 in sj.accesses():
            if a1 is a2 and _conflict(m1, m2) and r1.overlaps(r2):
                return True
    return False


def _still_reaches(src: Instruction, dst: Instruction) -> bool:
    """Is ``dst`` (still) an ancestor of ``src``?  Called post-removal."""
    seen = set()
    work = [src]
    while work:
        cur = work.pop()
        for d, _k in cur.dependencies:
            if d is dst:
                return True
            if d.iid not in seen:
                seen.add(d.iid)
                work.append(d)
    return False


def _index_of(stream: list[Instruction], instr: Instruction) -> int:
    """Identity scan (list.index would deep-compare dataclass fields)."""
    for i, x in enumerate(stream):
        if x is instr:
            return i
    return -1


def _remove_edge(instr: Instruction, dep: Instruction) -> Optional[DepKind]:
    """Drop the dep edge ``instr -> dep`` by identity (never Instruction ==,
    which is a deep dataclass comparison)."""
    for i, (d, k) in enumerate(instr.dependencies):
        if d is dep:
            del instr.dependencies[i]
            return k
    return None


def mutate_one(node_instrs: Sequence[list[Instruction]],
               pilots: list[Pilot], rng: random.Random, *,
               budgets: Optional[dict] = None) -> Optional[Mutation]:
    """Plant exactly one random defect in a lowered graph, in place.

    Returns the planted :class:`Mutation` (or ``None`` if no operator
    applies).  Operators are chosen in random order and all guarantee a
    non-equivalent mutant: edge deletions/retargets are restricted to
    invariant-bearing, non-redundant edges, so an honest verifier must
    flag every mutant this function produces.
    """
    num_nodes = len(node_instrs)
    ops = ["drop-edge", "retarget-edge", "cycle-edge", "drop-free",
           "double-free", "drop-alloc", "drop-frag", "retarget-send",
           "drop-pilot"]
    rng.shuffle(ops)
    snaps_cache: dict[int, list[_Snap]] = {}

    def snaps_of(n: int) -> list[_Snap]:
        if n not in snaps_cache:
            snaps_cache[n] = [_Snap(i) for i in node_instrs[n]]
        return snaps_cache[n]

    for op in ops:
        m = _try_op(op, node_instrs, pilots, rng, budgets, snaps_of, num_nodes)
        if m is not None:
            return m
    return None


def _try_op(op, node_instrs, pilots, rng, budgets, snaps_of, num_nodes):
    order = list(range(num_nodes))
    rng.shuffle(order)
    if op in ("drop-edge", "retarget-edge"):
        for n in order:
            stream = node_instrs[n]
            snaps = snaps_of(n)
            idx_of = {s.instr.iid: i for i, s in enumerate(snaps)}
            edges = [(i, d, k) for i, s in enumerate(snaps)
                     for d, k in s.instr.dependencies if d.iid in idx_of]
            rng.shuffle(edges)
            for i, d, k in edges[:400]:
                si, sj = snaps[i], snaps[idx_of[d.iid]]
                if not _edge_bearing(si, sj, budgets):
                    continue
                _remove_edge(si.instr, d)
                if _still_reaches(si.instr, d):
                    si.instr.dependencies.append((d, k))   # redundant: restore
                    continue
                if op == "retarget-edge":
                    si.instr.dependencies.append((stream[0], k))
                    detail = (f"retargeted dep {si.instr!r} -> {d!r} onto "
                              f"{stream[0]!r}")
                else:
                    detail = f"deleted dep edge {si.instr!r} -> {d!r}"
                return Mutation(op, n, (si.instr.iid, d.iid), detail)
    elif op == "cycle-edge":
        for n in order:
            snaps = snaps_of(n)
            if len(snaps) < 3:
                continue
            i = rng.randrange(len(snaps) - 1)
            anchor = snaps[i].instr
            desc = {anchor.iid}
            pool = []
            for s in snaps[i + 1:]:
                if any(d.iid in desc for d, _k in s.instr.dependencies):
                    desc.add(s.instr.iid)
                    pool.append(s.instr)
            if not pool:
                continue
            d = rng.choice(pool)
            anchor.dependencies.append((d, DepKind.SYNC))
            return Mutation("cycle-edge", n, (anchor.iid, d.iid),
                            f"cyclic dep {anchor!r} -> descendant {d!r}")
    elif op in ("drop-free", "double-free", "drop-alloc"):
        for n in order:
            stream = node_instrs[n]
            alloc_of = {i.allocation.aid: i for i in stream
                        if i.itype is _IT.ALLOC}
            frees = [i for i in stream if i.itype is _IT.FREE
                     and i.allocation.aid in alloc_of
                     and alloc_of[i.allocation.aid].persistent is False]
            if not frees:
                continue
            f = rng.choice(frees)
            a = alloc_of[f.allocation.aid]
            if op == "drop-free":
                del stream[_index_of(stream, f)]
                return Mutation(op, n, (f.iid, a.iid),
                                f"deleted {f!r} balancing {a!r}")
            if op == "drop-alloc":
                del stream[_index_of(stream, a)]
                return Mutation(op, n, (a.iid, f.iid),
                                f"deleted {a!r} freed by {f!r}")
            dup = Instruction(_IT.FREE, node=n, queue=f.queue,
                              allocation=f.allocation, name="free (dup)")
            dup.add_dependency(f, DepKind.SYNC)
            stream.insert(_index_of(stream, f) + 1, dup)
            return Mutation(op, n, (f.iid, dup.iid), f"duplicated {f!r}")
    elif op == "drop-frag":
        cands = [(n, i) for n in order for i in node_instrs[n]
                 if i.itype is _IT.COLL_SEND and len(i.coll_frags) >= 1]
        if cands:
            n, i = rng.choice(cands)
            k = rng.randrange(len(i.coll_frags))
            dropped = i.coll_frags[k]
            i.coll_frags = i.coll_frags[:k] + i.coll_frags[k + 1:]
            return Mutation("drop-frag", n, (i.iid,),
                            f"dropped fragment {dropped.key!r} from {i!r}")
    elif op == "retarget-send" and num_nodes > 1:
        cands = [(n, i) for n in order for i in node_instrs[n]
                 if i.itype in (_IT.SEND, _IT.COLL_SEND)]
        if cands:
            n, i = rng.choice(cands)
            old = i.dest
            i.dest = (i.dest + 1) % num_nodes
            return Mutation("retarget-send", n, (i.iid,),
                            f"retargeted {i!r} from N{old} to N{i.dest}")
    elif op == "drop-pilot":
        if pilots:
            k = rng.randrange(len(pilots))
            p = pilots.pop(k)
            key = (p.source, p.transfer_id, p.msg_id)
            for i in node_instrs[p.source]:
                if (i.itype in (_IT.SEND, _IT.COLL_SEND)
                        and (p.source, i.transfer_id, i.msg_id) == key):
                    return Mutation("drop-pilot", p.source, (i.iid,),
                                    f"dropped pilot for {i!r}")
            pilots.insert(k, p)   # no matching send: not a usable candidate
    return None


def run_mutation_campaign(build: Callable[[], tuple], *, mutants: int,
                          seed: int) -> CampaignResult:
    """Fuzz ``mutants`` single-defect graphs and score detection/attribution.

    ``build()`` must return a fresh ``(node_instrs, pilots, budgets, peaks)``
    tuple per call (``budgets``/``peaks`` may be ``None``); each mutant gets
    its own lowering so defects never compound.
    """
    out = CampaignResult()
    for k in range(mutants):
        rng = random.Random(seed * 1_000_003 + k)
        node_instrs, pilots, budgets, peaks = build()
        node_instrs = [list(s) for s in node_instrs]
        pilots = list(pilots)
        mut = mutate_one(node_instrs, pilots, rng, budgets=budgets)
        if mut is None:
            out.skipped += 1
            continue
        rep = verify_graph(node_instrs, pilots=pilots, budgets=budgets,
                           peaks=peaks)
        targets = set(mut.targets)
        att = any(targets & set(iss.instrs) for iss in rep.issues)
        out.results.append(MutantResult(mut, bool(rep.issues), att,
                                        tuple(rep.issues)))
    return out
