"""The traced run's timeline, read from ``torch.profiler``'s trace.

The profiler records CPU and CUDA activity over the window.  From its
Chrome trace this keeps the card's activities (kernels, copies, memsets)
by card, the harness's own spans (``portbench.*``), and the window, which
is the span ``portbench.window``.  Per-layer metrics read it.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Timeline:
    """Times in microseconds on the profiler's clock."""
    window: tuple[float, float]
    cards: list[int]
    device: list[tuple[int, str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self, card: int) -> list[tuple[float, float]]:
        """The card's busy intervals, clipped to the window."""
        w0, w1 = self.window
        return merge((max(s, w0), min(e, w1)) for c, _, s, e in self.device
                     if c == card and e > w0 and s < w1)

    def busy_s(self) -> float:
        """Seconds the cards were busy, averaged over the cards used."""
        return sum(e - s for c in self.cards for s, e in self.busy(c)) \
            / len(self.cards) / 1e6

    def gaps(self, card: int) -> list[tuple[float, float]]:
        """Idle intervals of the card inside the window."""
        w0, w1 = self.window
        out, t = [], w0
        for s, e in self.busy(card):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < w1:
            out.append((t, w1))
        return out

    def kernels(self, patterns) -> list[tuple[int, str, float, float]]:
        """Device activities whose name holds any of ``patterns``."""
        return [d for d in self.device if any(p in d[1] for p in patterns)]

    def union_s(self, activities) -> float:
        """Seconds in which any of ``activities`` ran, summed over cards:
        activities of several devices that share a card count once."""
        cards = {a[0] for a in activities}
        return sum(e - s for c in cards for s, e in
                   merge((s, e) for card, _, s, e in activities
                         if card == c)) / 1e6

    def host_doing(self, t: float) -> str:
        """The innermost harness span around time ``t``."""
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and name != "window" and (
                    best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "outside"

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        w0, w1 = self.window
        for _, name, s, e in self.device:
            d = min(e, w1) - max(s, w0)
            if d > 0:
                ops[name] = ops.get(name, 0.0) + d / 1e6
        gaps = sorted(((e - s, (s + e) / 2) for c in self.cards
                       for s, e in self.gaps(c)), reverse=True)[:top]
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": [[self.host_doing(m), d / 1e6]
                              for d, m in gaps]}


def read(prof, cards: list[int]) -> Timeline:
    """Export ``prof``'s trace to a temporary file and read it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events, cards)


def from_events(events: list[dict], cards: list[int]) -> Timeline:
    device, spans, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            card = int(ev.get("args", {}).get("device", ev.get("pid", 0)))
            device.append((card, name, s, e))
        elif cat == "user_annotation" and name.startswith("portbench."):
            short = name[len("portbench."):]
            spans.append((short, s, e))
            if short == "window":
                window = (s, e)
    if window is None:
        raise RuntimeError("the trace has no portbench.window span")
    return Timeline(window, cards, device, spans)
