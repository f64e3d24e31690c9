# Copied from src/repro/core/tracing.py; edited for the lanes' launch and
# sync stamps (record, lanes), garbage collections and the wall clock.
"""Per-instruction timeline capture — reproduces the paper's fig. 7 profiles.

The tracer records timestamped spans for the three concurrent activities the
paper visualizes: main-thread task submission, scheduler-thread graph
generation, and per-lane instruction execution.  ``overlap_fraction``
quantifies how much scheduling work was hidden behind execution — the
paper's headline qualitative claim for the concurrent architecture.

Records keep host stamps, and a device lane also stamps when its item has
launched and when the card has finished it, from which :meth:`Tracer.lanes`
derives the lane thread's ``lane.queue``, ``lane.launch`` and ``lane.sync``
spans and the executor's ``exec.wake``.  The tracer also records the
runtime's own spans (``sched.cdag``, ``sched.idag``, ``sched.throttle``,
``serve.*``), and a runtime's tracer every garbage collection
(``gc.gen0``-``gc.gen2`` on lane ``gc``, :meth:`Tracer.watch_gc`).
:meth:`Tracer.unix_us` puts a tracer time on the wall clock, which is the
clock of ``torch.profiler``'s Chrome trace.
"""

from __future__ import annotations

import bisect
import gc
import json
import threading
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from .observability import SCHED_KINDS, InstrRecord


@dataclass
class Span:
    lane: str          # "main" | "sched-N0" | "N0.D1.q0" | "N0.host" | ...
    kind: str          # "task" | "sched.idag" | "gc.gen2" | instruction type
    name: str
    t0: float
    t1: float
    # propagated trace context ({"tid": ..}, {"iid": .., "cid": .., ..}) —
    # exported as event args and used to derive Perfetto flow arrows
    meta: Optional[dict] = None


class Tracer:
    """Thread-safe append-only span log."""

    # executors skip per-instruction issue() callbacks for this tracer:
    # execution spans are derived from completion records, so issue-time
    # open-span tracking would only add a lock round-trip per instruction.
    # Duck-typed tracer doubles that want live issue events leave this True.
    issue_events = False
    # the least time between two anchors of the wall clock (anchor())
    ANCHOR_GAP_S = 0.1

    def __init__(self, *, record_sample: int = 1) -> None:
        self._lock = threading.Lock()
        # 1-in-N InstrRecord capture: with ``record_sample=N > 1`` only every
        # Nth completion is recorded, cutting traced issue overhead at the
        # cost of honestly widened gaps in the critical-path report (the
        # analyzer's ``unattributed_us`` absorbs the dropped records)
        self.record_sample = max(1, int(record_sample))
        self.records_sampled_out = 0
        self.spans: list[Span] = []
        # counter tracks: name -> [(t, value)] — used for the per-memory
        # byte high-water marks the budget acceptance checks read
        self.counters: dict[str, list[tuple[float, float]]] = defaultdict(list)
        # point-in-time events (fault injections, retransmits, aborts):
        # (lane, name, t, args) — rendered as Perfetto instant ("i") events
        self.instants: list[tuple[str, str, float, dict]] = []
        self._open: dict[tuple[int, int], float] = {}   # (node, iid) -> t_issue
        # per-instruction execution records (timing breakdown + trace
        # context); instruction spans are derived from these on demand, so
        # the executor's completion path appends exactly one object
        self.records: list[InstrRecord] = []
        self.epoch = time.perf_counter()
        # anchors of the wall clock: (perf_counter ns, wall clock less
        # perf_counter in ns), one now and one at each later anchor().
        # The two clocks need not run at one rate (a host whose wall clock
        # is being slewed), so unix_us interpolates between anchors.
        self._anchors: list[tuple[int, int]] = [_clock_pair()]
        self._unix_at_zero_ns = self._anchors[0][1]
        self._gc_hook = None

    def now(self) -> float:
        return time.perf_counter() - self.epoch

    def anchor(self) -> None:
        """Read the wall clock against ``perf_counter`` again, so that
        :meth:`unix_us` follows a difference in their rates up to now (the
        runtime's shutdown does, through :meth:`close`).  An anchor within
        ``ANCHOR_GAP_S`` of the last one is not taken: its rate would be
        noise."""
        pair = _clock_pair()
        with self._lock:
            if pair[0] - self._anchors[-1][0] >= self.ANCHOR_GAP_S * 1e9:
                self._anchors.append(pair)

    def unix_us(self, t: float, base_ns: int = 0) -> float:
        """Tracer time ``t`` on the wall clock: microseconds since
        ``base_ns`` nanoseconds after the Unix epoch.  ``torch.profiler``'s
        Chrome trace stamps ``(time_ns() - baseTimeNanoseconds) / 1e3``, so
        with its ``baseTimeNanoseconds`` as ``base_ns`` the result is that
        trace's ``ts``.  Between two anchors the offset of the two clocks
        is interpolated; before the first and after the last it is that
        anchor's."""
        p = (t + self.epoch) * 1e9
        anchors = self._anchors
        i = bisect.bisect_right(anchors, p, key=lambda a: a[0])
        if i == 0:
            off = anchors[0][1]
        elif i == len(anchors):
            off = anchors[-1][1]
        else:
            (p0, o0), (p1, o1) = anchors[i - 1], anchors[i]
            off = o0 + (p - p0) / (p1 - p0) * (o1 - o0)
        return (p + (off - base_ns)) / 1e3

    def watch_gc(self) -> None:
        """Record every garbage collection from now on as a span, until
        :meth:`close` (a runtime's tracer does, from construction)."""
        self._gc_hook = _gc_hook(weakref.ref(self))
        gc.callbacks.append(self._gc_hook)
        weakref.finalize(self, _remove_gc_hook, self._gc_hook)

    def close(self) -> None:
        """Stop recording garbage collections and take a last anchor of
        the wall clock (the runtime's shutdown)."""
        _remove_gc_hook(self._gc_hook)
        self.anchor()

    def span(self, lane: str, kind: str, name: str, t0: float, t1: float,
             meta: Optional[dict] = None) -> None:
        with self._lock:
            self.spans.append(Span(lane, kind, name, t0, t1, meta))

    def counter(self, name: str, value: float) -> None:
        """Record one sample of a named counter (e.g. ``N0.M2.bytes``)."""
        with self._lock:
            self.counters[name].append((self.now(), value))

    def instant(self, lane: str, name: str, args: dict | None = None) -> None:
        """Record a point event (drop/retransmit/abort/watchdog fire)."""
        with self._lock:
            self.instants.append((lane, name, self.now(), args or {}))

    def instant_counts(self) -> dict[str, int]:
        """Event-name histogram — chaos tests assert injections were traced."""
        out: dict[str, int] = defaultdict(int)
        with self._lock:
            for _, name, _, _ in self.instants:
                out[name] += 1
        return dict(out)

    def counter_peaks(self, suffix: str = ".bytes") -> dict[str, float]:
        """Max observed value per counter track ending in ``suffix``."""
        with self._lock:
            return {name: max(v for _, v in samples)
                    for name, samples in self.counters.items()
                    if name.endswith(suffix) and samples}

    # executor integration -------------------------------------------------
    def issue(self, node: int, instr) -> None:
        # ``_open`` is shared mutable state: hold the lock (concurrent
        # executors of different nodes issue/complete simultaneously)
        t = self.now()
        with self._lock:
            self._open[(node, instr.iid)] = t

    def complete(self, node: int, instr) -> None:
        # collective rounds carry a per-collective lane override so each
        # exchange renders as its own named Perfetto track (DESIGN.md §9)
        lane = getattr(instr, "trace_lane", None) \
            or f"N{node}." + ".".join(map(str, instr.queue))
        t1 = self.now()
        name = instr.name or repr(instr)
        with self._lock:
            t0 = self._open.pop((node, instr.iid), t1)
            self.spans.append(Span(lane, instr.itype.value, name, t0, t1))

    def record(self, node: int, instr, lane: str, *, t_reg: float,
               t_ready: float, t_start: float, t_done: float,
               wait_cls: str, blame_iid: Optional[int],
               t_launched: Optional[float] = None,
               t_synced: Optional[float] = None) -> None:
        """Append one instruction's full timing record (raw perf_counter
        stamps; converted to tracer-epoch time here).  Replaces the
        issue/complete pair on the executor's hot path: one lock, one
        append, and the fig.-7 execution span is derived lazily.  A
        device lane gives ``t_launched`` (its item has returned) and
        ``t_synced`` (the card has finished the item)."""
        rs = self.record_sample
        if rs > 1 and instr.iid % rs:
            # the keep/drop decision is a pure function of the iid so the
            # executor's completion path can short-circuit dropped records
            # without this call (it batches the drop count and flushes it
            # via ``note_sampled_out`` at horizon boundaries)
            with self._lock:
                self.records_sampled_out += 1
                self._open.pop((node, instr.iid), None)
                return
        e = self.epoch
        cmd = instr.command
        task = cmd.task if cmd is not None else None
        rec = InstrRecord(
            node, instr.iid, instr.itype.value, lane,
            instr.name or instr.itype.value,
            t_reg - e, t_ready - e, t_start - e, t_done - e,
            wait_cls, blame_iid,
            task.tid if task is not None else None,
            cmd.cid if cmd is not None else None,
            None if t_launched is None else t_launched - e,
            None if t_synced is None else t_synced - e)
        with self._lock:
            self.records.append(rec)
            self._open.pop((node, instr.iid), None)

    def note_sampled_out(self, n: int) -> None:
        """Credit ``n`` executor-side-dropped records (sampling fast path)."""
        if n:
            with self._lock:
                self.records_sampled_out += n

    # analysis ---------------------------------------------------------------
    def lanes(self) -> dict[str, list[Span]]:
        out: dict[str, list[Span]] = defaultdict(list)
        with self._lock:
            spans = list(self.spans)
            records = list(self.records)
        for s in spans:
            out[s.lane].append(s)
        for r in records:
            meta = {"iid": r.iid, "node": r.node, "tid": r.tid, "cid": r.cid}
            out[r.lane].append(Span(r.lane, r.kind, r.name, r.t_start,
                                    r.t_done, meta))
            if r.t_synced is not None:
                # the lane thread's and the executor's part of the item
                thread = "lane-" + r.lane
                for lane, kind, t0, t1 in (
                        (thread, "lane.queue", r.t_ready, r.t_start),
                        (thread, "lane.launch", r.t_start, r.t_launched),
                        (thread, "lane.sync", r.t_launched, r.t_synced),
                        (f"exec-N{r.node}", "exec.wake", r.t_synced,
                         r.t_done)):
                    out[lane].append(Span(lane, kind, r.name, t0, t1, meta))
        for v in out.values():
            v.sort(key=lambda s: s.t0)
        return out

    @staticmethod
    def _busy_intervals(spans: list[Span]) -> list[tuple[float, float]]:
        iv = sorted((s.t0, s.t1) for s in spans)
        merged: list[tuple[float, float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def overlap_fraction(self, lane_a_prefix: str, lane_b_prefix: str, *,
                         kind_a: str | None = None,
                         kind_b: str | None = None) -> float:
        """Fraction of lane-A busy time during which lane-B was also busy.

        ``kind_a``/``kind_b`` optionally restrict each side to spans of one
        kind (e.g. ``kind_a="reload"``, ``kind_b="device_kernel"`` measures
        how much reload traffic hid behind kernel execution).
        """
        lanes = self.lanes()
        a = self._busy_intervals([s for l, ss in lanes.items()
                                  if l.startswith(lane_a_prefix) for s in ss
                                  if kind_a is None or s.kind == kind_a])
        b = self._busy_intervals([s for l, ss in lanes.items()
                                  if l.startswith(lane_b_prefix) for s in ss
                                  if kind_b is None or s.kind == kind_b])
        total = sum(t1 - t0 for t0, t1 in a)
        if total == 0:
            return 0.0
        inter = 0.0
        j = 0
        for a0, a1 in a:
            while j < len(b) and b[j][1] < a0:
                j += 1
            k = j
            while k < len(b) and b[k][0] < a1:
                inter += max(0.0, min(a1, b[k][1]) - max(a0, b[k][0]))
                k += 1
        return inter / total

    def to_chrome_trace(self, path) -> int:
        """Export the span log as a Chrome/Perfetto trace-event JSON file.

        Each lane becomes a named thread of one process; spans are complete
        ("X") events with microsecond timestamps, so the fig.-7-style
        timeline can be inspected interactively in https://ui.perfetto.dev
        (or chrome://tracing).  Returns the number of events written.

        Timestamps are wall-clock microseconds (:meth:`unix_us`) since the
        tracer's epoch, written as ``baseTimeNanoseconds``, the key under
        which ``torch.profiler`` writes its own trace's base: ``ts`` plus
        the base over 1e3 is the same clock in both files.
        """
        base_ns = round(self.epoch * 1e9) + self._unix_at_zero_ns

        def us(t: float) -> float:
            return self.unix_us(t, base_ns)

        lanes = self.lanes()
        tids = {lane: i + 1 for i, lane in enumerate(sorted(lanes))}
        events: list[dict] = []
        for lane, tid in tids.items():
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name", "args": {"name": lane}})
        # trace-context indexes for the flow arrows: task spans on "main",
        # cdag/idag spans on "sched-N*" (the idag span, when present, is the
        # causally closest source for instruction arrows)
        task_src: dict[int, tuple[int, float]] = {}        # tid -> (ttid, ts)
        sched_src: dict[tuple[int, int], tuple[int, float]] = {}
        cdag_dst: list[tuple[int, int, int, float]] = []   # (node,tid,ttid,ts)
        instr_dst: list[tuple[int, int, Optional[int], int, float]] = []
        for lane, spans in lanes.items():
            tid = tids[lane]
            for s in spans:
                ev = {"ph": "X", "pid": 1, "tid": tid,
                      "name": s.name or s.kind, "cat": s.kind,
                      "ts": us(s.t0),
                      "dur": max((s.t1 - s.t0) * 1e6, 0.001)}
                if s.meta:
                    ev["args"] = {k: v for k, v in s.meta.items()
                                  if v is not None}
                events.append(ev)
                m = s.meta
                if not m:
                    continue
                if s.kind == "task" and m.get("tid") is not None:
                    task_src[m["tid"]] = (tid, ev["ts"])
                elif s.kind in SCHED_KINDS and lane.startswith("sched-N"):
                    node, ttid = int(lane[len("sched-N"):]), m.get("tid")
                    if ttid is None:
                        continue
                    if s.kind == "sched.cdag":
                        cdag_dst.append((node, ttid, tid, ev["ts"]))
                        sched_src.setdefault((node, ttid), (tid, ev["ts"]))
                    else:
                        sched_src[(node, ttid)] = (tid, ev["ts"])
                elif "iid" in m:
                    instr_dst.append((m.get("node", 0), m["iid"],
                                      m.get("tid"), tid, ev["ts"]))
        # flow arrows ("s"/"f"): task submission -> command generation ->
        # instruction execution, navigable causally in ui.perfetto.dev
        for node, ttid, tid, ts in cdag_dst:
            src = task_src.get(ttid)
            if src is None:
                continue
            fid = f"t{ttid}.N{node}"
            events.append({"ph": "s", "pid": 1, "tid": src[0], "ts": src[1],
                           "cat": "lower", "name": "lower", "id": fid})
            events.append({"ph": "f", "bp": "e", "pid": 1, "tid": tid,
                           "ts": ts, "cat": "lower", "name": "lower",
                           "id": fid})
        for node, iid, ttid, tid, ts in instr_dst:
            src = sched_src.get((node, ttid)) if ttid is not None else None
            if src is None:
                continue
            fid = f"i{node}.{iid}"
            events.append({"ph": "s", "pid": 1, "tid": src[0], "ts": src[1],
                           "cat": "lower", "name": "lower", "id": fid})
            events.append({"ph": "f", "bp": "e", "pid": 1, "tid": tid,
                           "ts": ts, "cat": "lower", "name": "lower",
                           "id": fid})
        # wait-state attribution: nested async spans under each instruction
        # lane — the pending wait (classified) followed by the queue wait
        with self._lock:
            records = list(self.records)
        for r in records:
            tid = tids.get(r.lane)
            if tid is None:
                continue
            wid = f"w{r.node}.{r.iid}"
            for name, t0, t1 in ((f"wait:{r.wait_cls}", r.t_reg, r.t_ready),
                                 ("wait:queue", r.t_ready, r.t_start)):
                if t1 - t0 <= 0:
                    continue
                events.append({"ph": "b", "pid": 1, "tid": tid, "cat": "wait",
                               "name": name, "id": wid, "ts": us(t0)})
                events.append({"ph": "e", "pid": 1, "tid": tid, "cat": "wait",
                               "name": name, "id": wid, "ts": us(t1)})
        # instant events (fault injections, retransmits, aborts) render as
        # thread-scoped markers on their wire/control lane
        with self._lock:
            instants = list(self.instants)
        for lane, name, t, args in instants:
            tid = tids.get(lane)
            if tid is None:
                tid = tids[lane] = len(tids) + 1
                events.append({"ph": "M", "pid": 1, "tid": tid,
                               "name": "thread_name", "args": {"name": lane}})
            events.append({"ph": "i", "s": "t", "pid": 1, "tid": tid,
                           "name": name, "ts": us(t), "args": args})
        # counter tracks (per-memory bytes, …) render as area charts
        with self._lock:
            counters = {k: list(v) for k, v in self.counters.items()}
        for name, samples in counters.items():
            for t, v in samples:
                events.append({"ph": "C", "pid": 1, "name": name,
                               "ts": us(t), "args": {"value": v}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, f)
        return len(events)

    def timeline_text(self, width: int = 78) -> str:
        """ASCII rendering of the fig.-7-style timeline."""
        lanes = self.lanes()
        if not lanes:
            return "(no spans)"
        tmax = max(s.t1 for ss in lanes.values() for s in ss) or 1e-9
        lines = []
        for lane in sorted(lanes):
            row = [" "] * width
            for s in lanes[lane]:
                i0 = min(width - 1, int(s.t0 / tmax * width))
                i1 = min(width - 1, max(i0, int(s.t1 / tmax * width)))
                for i in range(i0, i1 + 1):
                    row[i] = "#"
            lines.append(f"{lane:>16} |{''.join(row)}|")
        lines.append(f"{'':>16}  0{'':{width - 10}}{tmax * 1e3:8.2f}ms")
        return "\n".join(lines)


def _gc_hook(tracer_ref):
    """A ``gc.callbacks`` hook that records each collection as a span of
    the tracer behind ``tracer_ref`` (held weakly: the hook keeps no
    tracer alive).  It appends without the tracer's lock, which the
    collecting thread may hold already; ``list.append`` is atomic."""
    start = [0.0]

    def hook(phase: str, info: dict) -> None:
        if phase == "start":
            start[0] = time.perf_counter()
            return
        tr = tracer_ref()
        if tr is None:
            return
        kind = f"gc.gen{info['generation']}"
        tr.spans.append(Span("gc", kind, kind, start[0] - tr.epoch,
                             time.perf_counter() - tr.epoch,
                             {"collected": info["collected"]}))
    return hook


def _clock_pair() -> tuple[int, int]:
    """``(perf_counter ns, wall clock less perf_counter ns)`` from the
    tightest of a few back-to-back readings of both clocks."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix - (a + b) // 2)
    return best[1], best[2]


def _remove_gc_hook(hook) -> None:
    if hook in gc.callbacks:
        gc.callbacks.remove(hook)
