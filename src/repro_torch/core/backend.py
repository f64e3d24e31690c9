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
* When the executor traces, each lane leaves two host stamps on the item's
  tag: ``_launched_t`` when the item's function has returned (its work is
  queued) and ``_synced_t`` when that work is done.  A lane without a
  stream stamps both at once.
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


class InOrderQueue:
    """A FIFO worker thread — the analogue of a SYCL in-order queue.

    With a ``stream`` the thread enqueues each item's GPU work on it and
    waits for that work before pushing the completion.  With ``stamped``
    it leaves the launch and sync stamps on each item's tag.  The path is
    chosen here, once."""

    def __init__(self, name: str, sink: CompletionSink,
                 stream: Optional[torch.cuda.Stream] = None,
                 stamped: bool = False):
        self.name = name
        self.sink = sink
        self.stream = stream
        if stream is None:
            self._work = self._run_stamped_host if stamped else self._run_host
        else:
            self._work = self._run_stamped if stamped else self._run_stream
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
    each queue of a CUDA device owns a stream there.  With ``stamped`` (the
    executor traces) every queue stamps its items (:class:`InOrderQueue`).
    """

    def __init__(self, num_devices: int, *,
                 device_of: Callable[[int], torch.device],
                 queues_per_device: int = 2, host_threads: int = 4,
                 stamped: bool = False):
        self.sink = CompletionSink()
        self.num_devices = num_devices
        self.queues_per_device = queues_per_device

        def stream_for(d: int) -> Optional[torch.cuda.Stream]:
            dev = device_of(d)
            return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

        self.device_queues: list[list[InOrderQueue]] = [
            [InOrderQueue(f"D{d}.q{i}", self.sink, stream_for(d), stamped)
             for i in range(queues_per_device)]
            for d in range(num_devices)
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
