"""Backend submission queues (paper §4, fig. 5), on CUDA streams.

Port of ``src/repro/core/backend.py``.  The executor offloads actual work to
*backend* lanes so submission latency stays off its polling loop:

* ``InOrderQueue`` — a SYCL-style in-order queue: one worker thread drains a
  FIFO.  On a CUDA device the lane owns one ``torch.cuda.Stream``; the lane
  thread runs each item inside ``torch.cuda.stream(s)`` and reports the item
  done only after an event recorded on ``s`` has completed, so "done" means
  "data ready" exactly as with the reference's synchronous numpy lanes.
  The executor's *eager issue* rule (§4.1) relies on the lane's FIFO
  guarantee and stays correct unchanged.  On the CPU the lane is the
  reference's plain thread.
* When the executor traces, a lane with a stream times each item on the
  card.  It first launches a gate (:class:`CardGate`, a one-thread kernel
  that polls a word of pinned host memory) and records a start event
  behind it, runs the item, records a done event and only then opens the
  gate.  The stream therefore runs the item's operations back to back
  once the host has queued them all, and the two events bracket the card's
  execution of the item alone: the host's Python, GIL waits and driver
  calls between the item's torch calls fall before the start event.  Once
  the item is done the lane leaves the events' times on the item's tag as
  ``_card_t``: the card's start (after its record floor) and end on the
  host's ``perf_counter`` clock (:class:`CardClock`), and the gate's
  outcome.  A call that may wait for the card (a copy to or from pageable
  memory, a card tensor read on the host, a pinned allocation) runs inside
  :func:`whole_card`, which opens the item's own gate first and waits for
  every other gate to open; a gate also gives up after
  ``GATE_TIMEOUT_S``, so an item that synchronises unannounced is delayed,
  never hung.  Either way its interval then holds host time as well and
  the record says so.  Allocations queue no card work and run ungated.
  An executor without a tracer creates no gates and no timing events.
* A spans-only tracer gates and times nothing on the card: its lanes leave
  two host stamps on the item's tag instead, ``_launched_t`` when the
  item's function has returned and ``_synced_t`` when its work is done.
* ``HostPool`` — a pool of host worker threads for host tasks and host-side
  copies (no ordering guarantee; used only for *direct* issue).

Both report completions through a shared thread-safe completion list that the
executor drains in its polling loop, mirroring the event-polling approach the
paper adopts from [18]/[4].
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class WorkItem:
    """One unit of backend work: ``fn(tag)`` is invoked on the lane thread.

    Passing the tag (typically the Instruction) as the argument lets the
    executor submit bound methods directly instead of allocating a closure
    per instruction on the issue fast path.
    """
    fn: Callable[[object], None]
    tag: object = None                     # typically the Instruction
    card_work: bool = True                 # False: queues nothing on a card


class CompletionSink:
    """Thread-safe sink of finished work items, drained by the executor."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._done: list[tuple[object, Optional[BaseException], float]] = []
        self.event = threading.Event()

    def push(self, tag: object, err: Optional[BaseException], latency: float) -> None:
        with self._lock:
            self._done.append((tag, err, latency))
        if not self.event.is_set():
            self.event.set()

    def drain(self) -> list[tuple[object, Optional[BaseException], float]]:
        # clear BEFORE swapping: a push racing with the swap leaves the event
        # set for the next loop iteration instead of being lost (the executor
        # blocks on this event, so a lost wake-up would stall a full timeout)
        self.event.clear()
        with self._lock:
            out, self._done = self._done, []
        return out


def card_times(anchor, anchor_host: float, start, end,
               floor: float = 0.0) -> tuple[float, float]:
    """The card's interval between two completed timing events, on the
    host's ``perf_counter`` clock: ``anchor`` is a timing event of the same
    card that completed at host time ``anchor_host``.  The duration comes
    from the two events alone, not through the anchor, which keeps it to
    the events' own resolution however long ago the anchor was taken.  The
    start moves later by ``floor`` seconds, up to the end: what the card
    records for an item whose work is one minimal kernel (the events, and
    the launch latency that a record cannot tell from work)."""
    t0 = anchor_host + anchor.elapsed_time(start) / 1e3
    t1 = t0 + start.elapsed_time(end) / 1e3
    return min(t0 + floor, t1), t1


def clamp_to_ready(t0: float, t1: float,
                   t_ready: float) -> tuple[float, float]:
    """``(t_start, t_done)`` of a card interval: the start clamped to at
    least ``t_ready`` (the executor saw the instruction ready), the end to
    at least the start, so ``t_ready <= t_start <= t_done`` holds whatever
    the anchor's error."""
    t_start = max(t0, t_ready)
    return t_start, max(t1, t_start)


GATE_TIMEOUT_S = 0.1           # a gate that is never opened gives up here

_lane = threading.local()      # the gate of the item running on this thread
# closed gates and pending calls that wait for the whole card, process-wide
# (:func:`whole_card`)
_guard = threading.Condition()
_closed = 0
_pinning = 0


@contextmanager
def whole_card():
    """Around a call that may wait for the whole card (allocating pinned
    host memory, a copy to or from pageable memory): opens the running lane
    item's own gate, as early (its card interval then also holds the host's
    time from here on), waits until every other closed gate has opened, and
    keeps gates from closing until the call is done.  Otherwise the call
    would wait for a closed gate whose lane may wait for the driver in
    turn, until the gate gives up."""
    global _pinning
    gate = getattr(_lane, "gate", None)
    if gate is not None:
        gate.open(early=True)
    with _guard:
        _pinning += 1
        _guard.wait_for(lambda: _closed == 0)
    try:
        yield
    finally:
        with _guard:
            _pinning -= 1
            _guard.notify_all()


def _launch_gate(ptr: int, item: int, timeout_ns: int, stream: int) -> None:
    """Queue the gate kernel (``csrc/card_gate.cu``) on ``stream``."""
    from ..kernels import _build
    _build.check(_build.library().repro_card_gate(ptr, item, timeout_ns,
                                                  stream), "card gate launch")


class CardGate:
    """The gate of one timed lane: ``words`` (two int32, pinned host memory
    at device address ``ptr``) hold the last item the host has opened and
    the last item whose gate gave up; ``launch(ptr, item, timeout_ns,
    stream)`` queues the gate kernel of ``item`` on ``stream``."""

    def __init__(self, words, ptr: int,
                 launch: Callable[[int, int, int, int], None]) -> None:
        self.words, self.ptr, self._launch = words, ptr, launch
        self.item = 0
        self._early = False
        self._closed = False

    @classmethod
    def pinned(cls, n: int) -> list["CardGate"]:
        """``n`` gates whose words share one block of pinned host memory,
        allocated now (before any gate closes), launched through the kernel
        library (built on first launch)."""
        with whole_card():
            words = torch.zeros(2 * n, dtype=torch.int32, pin_memory=True)
        host, ptr = words.numpy(), words.data_ptr()
        gates = [cls(host[2 * i:2 * i + 2], ptr + 8 * i, _launch_gate)
                 for i in range(n)]
        for gate in gates:
            gate._keep = words              # owns the pinned memory
        return gates

    def close(self, stream: int) -> None:
        """Hold ``stream`` (a raw stream handle) at this point until
        :meth:`open` for the next item; waits while a call that waits for
        the whole card is pending."""
        global _closed
        with _guard:
            _guard.wait_for(lambda: _pinning == 0)
            _closed += 1
        self._closed, self._early = True, False
        # int32 item numbers, wrapping; the kernel compares differences
        self.item = (self.item + 1 + 2**31) % 2**32 - 2**31
        try:
            self._launch(self.ptr, self.item, int(GATE_TIMEOUT_S * 1e9),
                         stream)
        except BaseException:
            self.open()
            raise

    def open(self, early: bool = False) -> None:
        """Let the stream run on (once per item)."""
        global _closed
        if self._closed:
            self.words[0] = self.item
            self._closed, self._early = False, early
            with _guard:
                _closed -= 1
                _guard.notify_all()

    @property
    def outcome(self) -> str:
        """Read once the item's work is done (an item without card work,
        which is not gated, is ``"empty"``): ``"held"`` if the gate held
        the stream until the item had queued all of its work, ``"early"``
        if the item opened it before (:func:`whole_card`), ``"expired"``
        if the gate gave up waiting."""
        if self.words[1] == self.item:
            return "expired"
        return "early" if self._early else "held"


class CardClock:
    """One anchor event per card: recorded, synchronised, and the host's
    clock read at once after, when the executor starts.  Beside it the
    card's record floor (:func:`_record_floor_s`): every interval's start
    moves later by that much."""

    def __init__(self, devices) -> None:
        self._anchors: dict[int, tuple[torch.cuda.Event, float, float]] = {}
        for dev in devices:
            if dev.type != "cuda" or dev.index in self._anchors:
                continue
            with torch.cuda.device(dev):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ev.synchronize()
                host = time.perf_counter()
                self._anchors[dev.index] = (ev, host, _record_floor_s(dev))

    def times(self, index: int, start, end) -> tuple[float, float]:
        """The interval of two completed events on card ``index``."""
        anchor, host, floor = self._anchors[index]
        return card_times(anchor, host, start, end, floor)


def _record_floor_s(dev: torch.device, reps: int = 5) -> float:
    """Seconds between two timing events on card ``dev`` around one
    one-element kernel, queued behind fills so that the card meets them
    back to back (the least of ``reps``)."""
    stream = torch.cuda.Stream(device=dev)
    fill = torch.empty(1 << 26, dtype=torch.uint8, device=dev)
    one = torch.empty(1, device=dev)
    best = float("inf")
    with torch.cuda.stream(stream):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            for _ in range(8):          # busy while the host queues the rest
                fill.fill_(0)
            a.record()
            one.zero_()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
    return best


class InOrderQueue:
    """A FIFO worker thread — the analogue of a SYCL in-order queue.

    With a ``stream`` the thread enqueues each item's GPU work on it and
    waits for that work before pushing the completion.  ``mode`` is the
    executor's trace mode: ``"gated"`` gates each item behind ``gate`` and
    brackets it with timing events read through ``clock``; ``"spans"``
    leaves the launch and sync stamps on each item's tag; ``None`` does
    neither.  The path is chosen here, once."""

    def __init__(self, name: str, sink: CompletionSink,
                 stream: Optional[torch.cuda.Stream] = None,
                 mode: Optional[str] = None,
                 clock: Optional["CardClock"] = None,
                 gate: Optional[CardGate] = None):
        if mode not in (None, "gated", "spans"):
            raise ValueError(f"unknown trace mode {mode!r}")
        self.name = name
        self.sink = sink
        self.stream = stream
        self.clock = None
        if stream is None:
            # a host queue queues no card work: nothing to gate or time
            self._work = (self._run_stamped_host if mode == "spans"
                          else self._run_host)
        elif mode == "gated":
            self.clock = clock
            self._start = torch.cuda.Event(enable_timing=True)
            self._done = torch.cuda.Event(enable_timing=True)
            self._gate = gate
            self._work = self._run_gated
        else:
            self._work = (self._run_stamped if mode == "spans"
                          else self._run_stream)
        self._q: "queue.SimpleQueue[Optional[WorkItem]]" = queue.SimpleQueue()
        self._pending = 0                   # submitted, not yet completed
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def submit(self, item: WorkItem) -> None:
        with self._lock:
            self._pending += 1
        self._q.put(item)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            err: Optional[BaseException] = None
            t0 = time.perf_counter()
            try:
                self._work(item)
            except BaseException as e:  # noqa: BLE001 — reported to executor
                err = e
            with self._lock:
                self._pending -= 1
            self.sink.push(item.tag, err, time.perf_counter() - t0)

    @staticmethod
    def _run_host(item: WorkItem) -> None:
        item.fn(item.tag)

    @staticmethod
    def _run_stamped_host(item: WorkItem) -> None:
        item.fn(item.tag)
        item.tag._launched_t = item.tag._synced_t = time.perf_counter()

    def _run_stream(self, item: WorkItem) -> None:
        with torch.cuda.stream(self.stream):
            item.fn(item.tag)
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()

    def _run_stamped(self, item: WorkItem) -> None:
        """``_run_stream`` with the item's launch and sync stamped."""
        with torch.cuda.stream(self.stream):
            item.fn(item.tag)
        item.tag._launched_t = time.perf_counter()
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()
        item.tag._synced_t = time.perf_counter()

    def _run_gated(self, item: WorkItem) -> None:
        """Run ``item`` behind the gate, between the two timing events, and
        leave its card interval on its tag.  An item that queues no card
        work runs ungated and gets an empty interval at its done event."""
        if not item.card_work:
            with torch.cuda.stream(self.stream):
                item.fn(item.tag)
                self._done.record()
            self._done.synchronize()
            item.tag._card_t = (*self.clock.times(
                self.stream.device.index, self._done, self._done), "empty")
            return
        gate = self._gate
        with torch.cuda.stream(self.stream):
            gate.close(self.stream.cuda_stream)
            self._start.record()
            _lane.gate = gate
            try:
                item.fn(item.tag)
            finally:
                _lane.gate = None
                self._done.record()
                gate.open()
        self._done.synchronize()
        item.tag._card_t = (*self.clock.times(
            self.stream.device.index, self._start, self._done), gate.outcome)

    def shutdown(self, join_timeout: float = 5.0) -> int:
        """Stop the worker; returns 1 if it failed to join (leaked)."""
        self._q.put(None)
        self._thread.join(timeout=join_timeout)
        return 1 if self._thread.is_alive() else 0


class HostPool:
    """N host worker threads sharing one FIFO (no per-item ordering)."""

    def __init__(self, name: str, num_threads: int, sink: CompletionSink):
        self.name = name
        self.sink = sink
        self._q: "queue.SimpleQueue[Optional[WorkItem]]" = queue.SimpleQueue()
        self._threads = [threading.Thread(target=self._run, name=f"{name}-{i}",
                                          daemon=True)
                         for i in range(num_threads)]
        for t in self._threads:
            t.start()

    def submit(self, item: WorkItem) -> None:
        self._q.put(item)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.put(None)           # propagate shutdown to siblings
                return
            err: Optional[BaseException] = None
            t0 = time.perf_counter()
            try:
                item.fn(item.tag)
            except BaseException as e:  # noqa: BLE001
                err = e
            self.sink.push(item.tag, err, time.perf_counter() - t0)

    def shutdown(self, join_timeout: float = 5.0) -> int:
        """Stop all workers; returns how many failed to join (leaked)."""
        self._q.put(None)
        leaked = 0
        for t in self._threads:
            t.join(timeout=join_timeout)
            if t.is_alive():
                leaked += 1
        return leaked


class Backend:
    """All backend lanes of one node: per-device in-order queues + host pool.

    ``queues_per_device`` > 1 enables the paper's scheme of multiple in-order
    queues per device so independent copy/kernel instructions overlap (§4.1).
    A device instruction is routed round-robin unless eager issue pins it to
    the queue its dependencies are already on.

    ``device_of(d)`` names the torch device behind simulated device ``d``;
    each queue of a CUDA device owns a stream there.  ``trace`` is the
    executor's trace mode (``None``, ``"gated"`` or ``"spans"``, see
    :class:`InOrderQueue`); under ``"gated"`` those queues gate and time
    their items on the card, read through ``clock``.
    """

    def __init__(self, num_devices: int, *,
                 device_of: Callable[[int], torch.device],
                 queues_per_device: int = 2, host_threads: int = 4,
                 trace: Optional[str] = None):
        self.sink = CompletionSink()
        self.num_devices = num_devices
        self.queues_per_device = queues_per_device

        def stream_for(d: int) -> Optional[torch.cuda.Stream]:
            dev = device_of(d)
            return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

        gated = trace == "gated"
        self.clock = (CardClock(device_of(d) for d in range(num_devices))
                      if gated else None)
        streams = [[stream_for(d) for _ in range(queues_per_device)]
                   for d in range(num_devices)]
        n = sum(s is not None for qs in streams for s in qs) if gated else 0
        gates = iter(CardGate.pinned(n) if n else [])
        self.device_queues: list[list[InOrderQueue]] = [
            [InOrderQueue(f"D{d}.q{i}", self.sink, s, trace, self.clock,
                          next(gates) if s is not None and gated else None)
             for i, s in enumerate(qs)]
            for d, qs in enumerate(streams)
        ]
        self.host_pool = HostPool("host", host_threads, self.sink)
        self._rr = [0] * num_devices

    def pick_device_queue(self, device: int,
                          preferred: Optional[InOrderQueue] = None) -> InOrderQueue:
        if preferred is not None:
            return preferred
        qs = self.device_queues[device]
        # prefer an idle queue, else round-robin
        for q in qs:
            if q.pending == 0:
                return q
        self._rr[device] = (self._rr[device] + 1) % len(qs)
        return qs[self._rr[device]]

    def shutdown(self, join_timeout: float = 5.0) -> int:
        """Stop every lane; returns the total leaked-thread count."""
        leaked = 0
        for qs in self.device_queues:
            for q in qs:
                leaked += q.shutdown(join_timeout)
        leaked += self.host_pool.shutdown(join_timeout)
        return leaked
