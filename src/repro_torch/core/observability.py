# Copied from src/repro/core/observability.py; edited for the lanes' stamps (InstrRecord).
"""Flight recorder: unified metrics + critical-path / wait-state attribution.

The paper's claim is architectural — instruction-graph scheduling moves the
analysis work *off* the latency-critical path — but a claim about a critical
path is only testable with a critical-path analyzer.  This module provides
the measurement substrate the rest of the runtime hooks into:

* :class:`MetricsRegistry` — thread-safe counters, gauges and fixed-bucket
  histograms (p50/p95/p99) behind one namespace, unifying the previously
  scattered stat dicts (``comm_stats``, ``memory_report``,
  ``instant_counts``) into a single ``Runtime.metrics()`` snapshot.
* **Wait-state taxonomy** (:func:`classify_wait`) — every executed
  instruction's issue latency decomposes into *dep-wait* (last-arriving
  predecessor), *budget-wait* (blocked behind eviction/FREE anchors),
  *transport-wait* (pilot/retransmit/ack stalls) and *queue-wait* (lane
  contention).  The decomposition is exact by construction:
  ``pending + queue == t_start - t_reg`` per instruction.
* :func:`critical_path` — walks the completed-instruction records backwards
  along last-arriving-predecessor ("blame") links, crossing into the
  scheduler (cdag/idag) and main-thread (task) spans at the chain head, and
  reports the longest cost-weighted chain with per-layer and per-wait-class
  totals — a machine-readable answer to "is scheduling on the critical
  path, and if not, what is".

Metric naming scheme (DESIGN.md §11): ``layer.node.name``, e.g.
``executor.N0.issue_us``, ``sched.N1.horizon_lag``, ``memory.N0.spills``.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

from .instructions import InstructionType

# -- wait-state taxonomy (DESIGN.md §11.2) ----------------------------------

WAIT_DEP = "dep"              # last-arriving predecessor was compute/copy
WAIT_BUDGET = "budget"        # blocked behind FREE/SPILL/RELOAD (eviction)
WAIT_TRANSPORT = "transport"  # blocked behind send/receive completion
WAIT_QUEUE = "queue"          # ready but waiting for a backend lane

WAIT_CLASSES = (WAIT_DEP, WAIT_BUDGET, WAIT_TRANSPORT, WAIT_QUEUE)

_BUDGET_TYPES = frozenset((InstructionType.FREE, InstructionType.SPILL,
                           InstructionType.RELOAD))
_TRANSPORT_TYPES = frozenset((
    InstructionType.SEND, InstructionType.COLL_SEND, InstructionType.RECEIVE,
    InstructionType.SPLIT_RECEIVE, InstructionType.AWAIT_RECEIVE,
    InstructionType.GATHER_RECEIVE, InstructionType.COLL_RECV))


def classify_wait(blame_itype: Optional[InstructionType]) -> str:
    """Wait class of a pending interval, from its last-arriving predecessor.

    ``None`` (no blamed predecessor — e.g. eager issue, or ready at
    registration) defaults to dep-wait: the wait, if any, was for an
    ordinary dependency whose identity the executor did not capture.
    """
    if blame_itype is None:
        return WAIT_DEP
    if blame_itype in _BUDGET_TYPES:
        return WAIT_BUDGET
    if blame_itype in _TRANSPORT_TYPES:
        return WAIT_TRANSPORT
    return WAIT_DEP


# precomputed lookup for the executor completion path (dict.get beats two
# frozenset probes per instruction)
WAIT_OF = {it: classify_wait(it) for it in InstructionType}


# -- histograms --------------------------------------------------------------

_NBUCKETS = 28    # log2 buckets over microseconds: covers ns .. ~2 minutes


class Histogram:
    """Fixed-bucket log2 histogram of microsecond values.

    Bucket ``i`` holds values ``v`` with ``int(v).bit_length() == i``, i.e.
    ``[2^(i-1), 2^i)`` microseconds (bucket 0: ``[0, 1)``).  ``observe`` is
    deliberately branch-light — it sits on the executor issue path.  A
    histogram is single-writer by convention (names embed the node id);
    readers take a point-in-time copy under the registry lock.
    """

    __slots__ = ("counts", "n", "total", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * _NBUCKETS
        self.n = 0
        self.total = 0.0
        self.vmax = 0.0

    def observe(self, us: float) -> None:
        self.n += 1
        self.total += us
        if us > self.vmax:
            self.vmax = us
        i = int(us).bit_length()
        self.counts[i if i < _NBUCKETS else _NBUCKETS - 1] += 1

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile estimate (exact to bucket width)."""
        if self.n == 0:
            return 0.0
        rank = (p / 100.0) * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else float(1 << (i - 1))
                hi = float(1 << i)
                est = lo + (hi - lo) * max(0.0, rank - cum) / c
                return min(est, self.vmax) if self.vmax > 0 else est
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        return dict(count=self.n, sum_us=self.total, max_us=self.vmax,
                    p50=self.percentile(50), p95=self.percentile(95),
                    p99=self.percentile(99))


class MetricsRegistry:
    """Thread-safe metric namespace: counters, gauges, histograms.

    Counters accumulate (monotone), gauges hold the last sampled value, and
    histograms aggregate latency-style observations.  ``histogram()``
    returns the live object so hot paths can cache it and observe without
    touching the registry lock (single-writer per name, see
    :class:`Histogram`).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def observe(self, name: str, us: float) -> None:
        self.histogram(name).observe(us)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(counters=dict(self._counters),
                        gauges=dict(self._gauges),
                        histograms={k: h.snapshot()
                                    for k, h in self._hists.items()})

    def export_counters(self, tracer) -> None:
        """Write final counter/gauge values as Perfetto counter samples."""
        with self._lock:
            items = list(self._counters.items()) + list(self._gauges.items())
        for name, value in items:
            tracer.counter(name, float(value))


# -- per-instruction execution records ---------------------------------------


@dataclass(slots=True)
class InstrRecord:
    """One executed instruction's full timing breakdown (tracer-epoch secs).

    ``t_reg <= t_ready <= t_start <= t_done``: registration at the executor,
    last dependency arrival, backend-lane dequeue, completion.  The issue
    latency ``t_start - t_reg`` decomposes exactly into the pending wait
    (``t_ready - t_reg``, classified by ``wait_cls``) plus the queue wait
    (``t_start - t_ready``).  ``blame_iid`` names the last-arriving
    predecessor (same-node iid) — the critical-path walk follows it.

    A device lane also gives ``t_launched`` (the item has queued its work)
    and ``t_synced`` (the lane saw the work finish): ``t_start <=
    t_launched <= t_synced <= t_done``.  Elsewhere both are None.
    """

    node: int
    iid: int
    kind: str
    lane: str
    name: str
    t_reg: float
    t_ready: float
    t_start: float
    t_done: float
    wait_cls: str
    blame_iid: Optional[int]
    tid: Optional[int]
    cid: Optional[int]
    t_launched: Optional[float] = None
    t_synced: Optional[float] = None


# -- lane utilization ---------------------------------------------------------


def lane_utilization(records) -> dict:
    """Per-lane busy/idle occupancy from completed :class:`InstrRecord`s.

    Busy time is the union of ``[t_start, t_done]`` execution intervals per
    ``(node, lane)`` (overlaps merged, so concurrent sub-intervals are not
    double-counted); the observation window is the global first-start to
    last-done span.  Returns ``{"N<node>.<lane>": {busy_us, idle_us,
    busy_frac, raw_busy_us, instructions}, ..., "span_us": ...,
    "occupancy": ..., "device_occupancy": ...}``.

    ``occupancy`` is the mean merged busy fraction over all lanes;
    ``raw_busy_us`` is the unmerged per-lane sum of instruction durations.
    A device lane runs one instruction per hardware queue, and the lane key
    merges the queues — so when the issue window keeps several kernels in
    flight, merged busy shrinks while raw busy is conserved.
    ``device_occupancy`` = total raw device-lane busy / (span x device
    lanes) is therefore the pipelining-depth headline: serialized issue
    caps it at the single-queue fraction, overlap raises it (>1 means more
    than one kernel in flight per device on average).
    """
    by_lane: dict[tuple[int, str], list[tuple[float, float]]] = \
        defaultdict(list)
    t0, t1 = float("inf"), float("-inf")
    for r in records:
        if r.t_done <= r.t_start:
            continue
        by_lane[(r.node, r.lane)].append((r.t_start, r.t_done))
        t0 = min(t0, r.t_start)
        t1 = max(t1, r.t_done)
    if not by_lane:
        return dict(span_us=0.0, occupancy=0.0, lanes={})
    span = t1 - t0
    lanes: dict[str, dict] = {}
    fracs: list[float] = []
    dev_raw, dev_lanes = 0.0, 0
    for (node, lane), ivals in sorted(by_lane.items()):
        ivals.sort()
        raw = sum(b - a for a, b in ivals)
        busy = 0.0
        cur_a, cur_b = ivals[0]
        for a, b in ivals[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        frac = busy / span if span > 0 else 0.0
        fracs.append(frac)
        if "device" in lane:
            dev_raw += raw
            dev_lanes += 1
        lanes[f"N{node}.{lane}"] = dict(
            busy_us=busy * 1e6, idle_us=max(0.0, span - busy) * 1e6,
            busy_frac=frac, raw_busy_us=raw * 1e6, instructions=len(ivals))
    dev_occ = (dev_raw / (span * dev_lanes)
               if span > 0 and dev_lanes else 0.0)
    return dict(span_us=span * 1e6,
                occupancy=sum(fracs) / len(fracs),
                device_occupancy=dev_occ, lanes=lanes)


# -- critical-path analysis --------------------------------------------------

# instruction kind -> pipeline layer, for the per-layer totals
_LAYER_OF = {
    "device_kernel": "kernel", "host_task": "kernel",
    "alloc": "memory", "free": "memory", "copy": "memory",
    "spill": "memory", "reload": "memory",
    "send": "comm", "coll_send": "comm", "receive": "comm",
    "split_receive": "comm", "await_receive": "comm",
    "gather_receive": "comm", "coll_recv": "comm",
    "fill_identity": "reduce", "local_reduce": "reduce",
    "global_reduce": "reduce",
    "horizon": "sync", "epoch": "sync",
}

# the scheduler's lowering spans of one task (critical path, flow arrows)
SCHED_KINDS = ("sched.cdag", "sched.idag")

_LAYER_ORDER = ("kernel", "comm", "reduce", "memory", "sync", "other",
                "scheduler", "main")


@dataclass
class CriticalPathReport:
    """Longest cost-weighted chain through the completed execution."""

    total_us: float                      # chain start -> final completion
    by_layer: dict[str, float] = field(default_factory=dict)      # us
    by_wait: dict[str, float] = field(default_factory=dict)       # us, on-path
    aggregate_wait_us: dict[str, float] = field(default_factory=dict)
    unattributed_us: float = 0.0
    chain_len: int = 0
    n_instructions: int = 0
    steps: list = field(default_factory=list)     # InstrRecords, end-first

    @property
    def scheduler_fraction(self) -> float:
        """Share of the critical path spent lowering in scheduler lanes
        (``sched.cdag`` + ``sched.idag``; a throttled wait is no lowering).

        The paper's off-critical-path claim, quantified: this should stay
        well under 1 for execution-bound programs.
        """
        if self.total_us <= 0:
            return 0.0
        return self.by_layer.get("scheduler", 0.0) / self.total_us

    def as_dict(self) -> dict:
        return dict(total_us=self.total_us, by_layer=dict(self.by_layer),
                    by_wait=dict(self.by_wait),
                    aggregate_wait_us=dict(self.aggregate_wait_us),
                    unattributed_us=self.unattributed_us,
                    chain_len=self.chain_len,
                    n_instructions=self.n_instructions,
                    scheduler_fraction=self.scheduler_fraction)

    def render(self) -> str:
        lines = [f"critical path: {self.total_us / 1e3:.2f} ms end-to-end, "
                 f"{self.chain_len} chain steps of "
                 f"{self.n_instructions} traced instructions"]
        lines.append("  on-path time by layer:")
        for layer in _LAYER_ORDER:
            us = self.by_layer.get(layer)
            if us is None:
                continue
            pct = 100.0 * us / self.total_us if self.total_us else 0.0
            note = "   <- scheduling lanes" if layer == "scheduler" else ""
            lines.append(f"    {layer:<10} {us / 1e3:10.3f} ms "
                         f"{pct:5.1f}%{note}")
        if self.unattributed_us > 0:
            pct = 100.0 * self.unattributed_us / self.total_us \
                if self.total_us else 0.0
            lines.append(f"    {'(gaps)':<10} "
                         f"{self.unattributed_us / 1e3:10.3f} ms {pct:5.1f}%")
        if self.by_wait:
            lines.append("  on-path waits: " + "  ".join(
                f"{k}={v / 1e3:.3f}ms" for k, v in
                sorted(self.by_wait.items())))
        if self.aggregate_wait_us:
            lines.append("  aggregate waits (all instructions): " + "  ".join(
                f"{k}={v / 1e3:.3f}ms" for k, v in
                sorted(self.aggregate_wait_us.items())))
        lines.append(f"  scheduler share of critical path: "
                     f"{100.0 * self.scheduler_fraction:.2f}%")
        return "\n".join(lines)


def critical_path(tracer) -> CriticalPathReport:
    """Walk the completed-span DAG backwards along blame links.

    Starting from the last instruction to complete, each step accounts the
    instruction's execution interval to its layer and its queue wait to the
    wait totals, then follows ``blame_iid`` to the predecessor whose
    completion made it ready (monotonically decreasing ``t_done``, so the
    walk terminates).  At the chain head — an instruction that was ready
    the moment it was registered — the walk climbs into the scheduler's
    idag/cdag spans and the main-thread task span via the propagated task
    id, attributing lowering time to the ``scheduler`` and ``main`` layers.
    """
    with tracer._lock:
        recs_list = list(tracer.records)
        spans = list(tracer.spans)
    recs = {(r.node, r.iid): r for r in recs_list}
    if not recs:
        return CriticalPathReport(total_us=0.0)

    # scheduler / main spans indexed by the propagated task id
    sched_spans: dict[tuple[int, int, str], object] = {}
    task_spans: dict[int, object] = {}
    for s in spans:
        meta = s.meta
        if not meta:
            continue
        tid = meta.get("tid")
        if tid is None:
            continue
        if s.kind == "task":
            task_spans[tid] = s
        elif s.kind in SCHED_KINDS and s.lane.startswith("sched-N"):
            node = int(s.lane[len("sched-N"):])
            sched_spans[(node, tid, s.kind)] = s

    by_layer: dict[str, float] = defaultdict(float)
    by_wait: dict[str, float] = defaultdict(float)
    agg_wait: dict[str, float] = defaultdict(float)
    for r in recs_list:
        agg_wait[r.wait_cls] += max(0.0, r.t_ready - r.t_reg) * 1e6
        agg_wait[WAIT_QUEUE] += max(0.0, r.t_start - r.t_ready) * 1e6

    # unified activity timeline for temporal-predecessor jumps: when the
    # causal (blame) chain dries up at an instruction that was ready the
    # moment it was registered, the run before that point was bounded by
    # whatever finished last — another instruction, a scheduler lowering
    # span, or a main-thread submission span — so all three are walkable.
    acts: list[tuple[float, str, object]] = \
        [(r.t_done, "rec", r) for r in recs_list]
    for s in sched_spans.values():
        acts.append((s.t1, "scheduler", s))
    for s in task_spans.values():
        acts.append((s.t1, "main", s))
    acts.sort(key=lambda a: a[0])
    ends = [a[0] for a in acts]
    eps = 1e-6

    cur = max(recs_list, key=lambda r: r.t_done)
    end = cur.t_done
    # earliest instant already accounted: every interval is clipped against
    # it before being added, so the walk's decomposition is DISJOINT — the
    # layer + wait totals can never exceed the end-to-end time, and the
    # remainder is reported honestly as unattributed gaps
    frontier = end
    steps: list[InstrRecord] = []
    visited: set[tuple[int, int]] = set()
    span_seen: set[int] = set()

    def account(dst: dict, key: str, a: float, b: float) -> None:
        nonlocal frontier
        b = min(b, frontier)
        if b <= a:
            return
        dst[key] += (b - a) * 1e6
        frontier = a

    while cur is not None:
        visited.add((cur.node, cur.iid))
        steps.append(cur)
        account(by_layer, _LAYER_OF.get(cur.kind, "other"),
                cur.t_start, cur.t_done)
        nxt = recs.get((cur.node, cur.blame_iid)) \
            if cur.blame_iid is not None else None
        if nxt is not None and nxt.t_done < cur.t_done \
                and (nxt.node, nxt.iid) not in visited:
            # the predecessor's own execution explains the pending interval
            # (and, for eager issue, part of the in-queue interval too);
            # only the slack after its completion counts as a wait
            account(by_wait, WAIT_QUEUE,
                    max(cur.t_ready, nxt.t_done), cur.t_start)
            account(by_wait, cur.wait_cls,
                    max(cur.t_reg, nxt.t_done), cur.t_ready)
            cur = nxt
            continue
        account(by_wait, WAIT_QUEUE, cur.t_ready, cur.t_start)
        # chain head: no recorded predecessor — the pending interval is a
        # genuine unexplained wait, and lowering time becomes visible
        account(by_wait, cur.wait_cls, cur.t_reg, cur.t_ready)
        if cur.tid is not None:
            for kind in ("sched.idag", "sched.cdag"):
                s = sched_spans.get((cur.node, cur.tid, kind))
                if s is not None and id(s) not in span_seen:
                    span_seen.add(id(s))
                    account(by_layer, "scheduler", s.t0, s.t1)
            ts = task_spans.get(cur.tid)
            if ts is not None and id(ts) not in span_seen:
                span_seen.add(id(ts))
                account(by_layer, "main", ts.t0, ts.t1)
        # temporal predecessor: the last unvisited activity before the
        # accounted frontier (any remaining gap stays unattributed);
        # scheduler/main spans encountered here are accounted in place and
        # the scan continues until the next instruction record is found
        cur = None
        i = bisect_right(ends, frontier + eps) - 1
        while i >= 0 and cur is None:
            t1, akind, obj = acts[i]
            i -= 1
            if akind == "rec":
                if (obj.node, obj.iid) not in visited:
                    cur = obj
            elif id(obj) not in span_seen:
                span_seen.add(id(obj))
                account(by_layer, akind, obj.t0, obj.t1)
                i = bisect_right(ends, frontier + eps) - 1

    total_us = max(0.0, end - frontier) * 1e6
    accounted = sum(by_layer.values()) + sum(by_wait.values())
    return CriticalPathReport(
        total_us=total_us, by_layer=dict(by_layer), by_wait=dict(by_wait),
        aggregate_wait_us=dict(agg_wait),
        unattributed_us=max(0.0, total_us - accounted),
        chain_len=len(steps), n_instructions=len(recs_list), steps=steps)
