"""The runtime's own spans on the profiler's clock, and what a traced run
reads from them.

A runtime built with ``trace="spans"`` keeps a ``Tracer`` that records, on
its own threads, where the card can end up waiting: lowering
(``sched.cdag``, ``sched.idag``), the scheduler's run-ahead limit
(``sched.throttle``), each device-lane item's wait for its lane
(``lane.queue``), launch (``lane.launch``) and wait for the card
(``lane.sync``), the executor's wake-up on its completion (``exec.wake``),
the serving client (``serve.replay``, ``serve.lower``, ``serve.wait``) and
garbage collections (``gc.gen0``-``gc.gen2``).  ``torch.profiler`` records
no span of a thread other than the one that started it, so these stay in
the tracer, and :func:`program_spans` puts them on the Chrome trace's
clock through ``Tracer.unix_us`` and the trace's ``baseTimeNanoseconds``.

A program without that tracer, or without ``Tracer.unix_us``, gives no
spans, and every reading here is then None.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Optional

import numpy as np

from portbench.harness.trace import Timeline, from_events

# Where spans of several threads overlap a piece of the cards' idle time,
# the piece goes to the first of these that is open (a name, or a prefix
# ending in "."): a collection stops every thread; a launch, a wake-up or a
# lane's queue is the next card work on its way; the serving client and
# the schedulers come after.  ``lane.sync`` comes last: a lane waits there
# while the card works, so over idle time it is the lane's own wake-up.
ORDER = ("gc.", "lane.launch", "exec.wake", "lane.queue", "serve.",
         "sched.idag", "sched.cdag", "sched.throttle", "lane.sync")
# a finer order for looking into single gaps: the host-side instructions in
# flight (``instr.<kind>``: host pool and communicator) before the serving
# client's spans, and the main thread's submissions (``task``)
DETAIL = ORDER[:4] + ("instr.",) + ORDER[4:-1] + ("task", "lane.sync")
UNTRACED = "(untraced)"


def rank(name: str, order=ORDER) -> Optional[int]:
    """The place of span ``name`` in ``order``; None if not there."""
    for i, p in enumerate(order):
        if name == p or (p.endswith(".") and name.startswith(p)):
            return i
    return None


def export(prof) -> dict:
    """``prof``'s Chrome trace, as exported."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def read_trace(prof, cards: list[int]) -> tuple[Timeline, Optional[int]]:
    """``prof``'s timeline (``trace.read``) and its trace's
    ``baseTimeNanoseconds`` (None where the trace has none)."""
    data = export(prof)
    return from_events(data["traceEvents"], cards), \
        data.get("baseTimeNanoseconds")


def clock_probes(tracer, n: int = 20) -> list[float]:
    """Under a new profiler session, ``n`` tracer stamps each taken just
    before a ``record_function`` opens: each converted stamp less that
    span's ``ts``, in microseconds, in order (the first is the session's
    first span)."""
    import torch
    from portbench.harness.trace import profiler
    prof = profiler()
    prof.start()
    stamps = []
    for i in range(n):
        stamps.append(tracer.now())
        with torch.profiler.record_function(f"portbench.probe{i}"):
            pass
    prof.stop()
    data = export(prof)
    base = data.get("baseTimeNanoseconds")
    ts = {e["name"]: e["ts"] for e in data["traceEvents"]
          if e.get("ph") == "X" and e.get("name", "").startswith(
              "portbench.probe")}
    return [tracer.unix_us(t, base) - ts[f"portbench.probe{i}"]
            for i, t in enumerate(stamps) if f"portbench.probe{i}" in ts]


def program_spans(tracer, base_ns: Optional[int],
                  window: tuple[float, float]) -> list[tuple]:
    """The tracer's spans of :data:`DETAIL` that overlap ``window``
    (microseconds on the profiler's clock), as ``(name, lane, start, end,
    meta)`` on that clock; a meta's ``epoch_done`` is converted too.  An
    instruction off the device lanes is named ``instr.<kind>``.  Empty
    where the program has no such tracer or the trace no base."""
    if tracer is None or base_ns is None or not hasattr(tracer, "unix_us"):
        return []
    w0, w1 = window
    out = []
    for lane, spans in tracer.lanes().items():
        host = lane.startswith("N") and ".device." not in lane
        for s in spans:
            name = f"instr.{s.kind}" if host else s.kind
            if rank(name, DETAIL) is None:
                continue
            a = tracer.unix_us(s.t0, base_ns)
            b = tracer.unix_us(s.t1, base_ns)
            if b < w0 or a > w1:
                continue
            meta = dict(s.meta or {})
            if "epoch_done" in meta:
                meta["epoch_done"] = tracer.unix_us(meta["epoch_done"],
                                                    base_ns)
            out.append((name, lane, a, b, meta))
    return out


def _clipped(spans, window, names) -> list[float]:
    w0, w1 = window
    return [min(e, w1) - max(s, w0) for n, _, s, e, _ in spans
            if n in names and e > w0 and s < w1]


def lower_us_per_step(spans, window, units: int) -> Optional[float]:
    """Lowering (``sched.cdag`` + ``sched.idag``) in the window, summed
    over the scheduler threads, per step."""
    d = _clipped(spans, window, ("sched.cdag", "sched.idag"))
    return sum(d) / units if d and units else None


def median_us(spans, window, name: str) -> Optional[float]:
    """The median length of the spans ``name`` that start in the window
    (``lane.launch``, ``exec.wake``: only device-lane items have them)."""
    w0, w1 = window
    d = [e - s for n, _, s, e, _ in spans if n == name and w0 <= s <= w1]
    return float(np.median(d)) if d else None


def window_wake_us_p50(spans, window) -> Optional[float]:
    """Over the client's waits that end in the window, the median time
    from the window's completion on the last node to the wait's end."""
    w0, w1 = window
    d = [e - m["epoch_done"] for n, _, s, e, m in spans
         if n == "serve.wait" and "epoch_done" in m and w0 <= e <= w1]
    return float(np.median(d)) if d else None


def idle_by_name(idle: list[tuple[float, float]], spans,
                 order=ORDER) -> dict[str, float]:
    """Microseconds of the intervals ``idle`` (sorted, disjoint) under each
    span name, each piece given to the first open span of ``order``; time
    under none is :data:`UNTRACED`."""
    ranks = {n: rank(n, order) for n, *_ in spans}
    events = sorted((t, d, n) for n, _, s, e, _ in spans
                    if ranks[n] is not None
                    for t, d in ((s, 1), (e, -1)))
    active: dict[str, int] = defaultdict(int)
    out: dict[str, float] = defaultdict(float)
    i = 0

    def top() -> str:
        open_ = [n for n, k in active.items() if k > 0]
        return min(open_, key=ranks.get) if open_ else UNTRACED

    for s, e in idle:
        while i < len(events) and events[i][0] <= s:
            active[events[i][2]] += events[i][1]
            i += 1
        t = s
        while t < e:
            nxt = events[i][0] if i < len(events) and events[i][0] < e else e
            if nxt > t:
                out[top()] += nxt - t
            t = nxt
            while i < len(events) and events[i][0] <= t and t < e:
                active[events[i][2]] += events[i][1]
                i += 1
    return dict(out)


def card_idle(tl: Timeline) -> list[list[tuple[float, float]]]:
    """Each card's idle intervals in the window."""
    return [tl.gaps(c) for c in tl.cards]


def idle_traced_share(tl: Timeline, spans) -> Optional[float]:
    """The share of the cards' idle time in the window that lies under at
    least one runtime span, in percent."""
    if not spans:
        return None
    total = traced = 0.0
    for idle in card_idle(tl):
        by = idle_by_name(idle, spans)
        total += sum(by.values())
        traced += sum(v for k, v in by.items() if k != UNTRACED)
    return 100.0 * traced / total if total > 0 else None


def idle_by_program(tl: Timeline, spans, top: int = 10) -> list:
    """``[name, seconds]`` of the ``top`` span names (and
    :data:`UNTRACED`) that cover the most card-idle time in the window."""
    if not spans:
        return []
    out: dict[str, float] = defaultdict(float)
    for idle in card_idle(tl):
        for k, v in idle_by_name(idle, spans).items():
            out[k] += v / 1e6
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]


def longest_gaps(tl: Timeline, spans, top: int = 5) -> list:
    """The ``top`` longest idle gaps: ``[seconds, start, [[name, seconds],
    ...]]``, ``start`` in seconds from the window's start, with each gap's
    time by span name in the :data:`DETAIL` order."""
    gaps = sorted(((e - s, s, e) for idle in card_idle(tl)
                   for s, e in idle), reverse=True)[:top]
    out = []
    for d, s, e in gaps:
        by = idle_by_name([(s, e)], spans, DETAIL)
        out.append([d / 1e6, (s - tl.window[0]) / 1e6,
                    sorted(([k, v / 1e6] for k, v in by.items()),
                           key=lambda kv: -kv[1])])
    return out
