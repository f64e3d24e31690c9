# Copied from src/repro/core/faults.py.
"""Fault injection and failure vocabulary (DESIGN.md §10).

The scheduler core assumes nothing about the wire or its peers beyond what
this module models: a :class:`FaultPlan` is a *deterministic, seeded* chaos
schedule — drop/delay/duplicate/reorder decisions for pilots and payloads,
crash-rank-at-instruction-k and slow-rank — that the ``Communicator`` and
``Executor`` consult at their injection points.  Decisions are a pure hash
of ``(seed, kind, transfer_id, msg_id, attempt)``, all of which are fixed at
compile time, so a chaos schedule is replayable by seed regardless of thread
interleaving.  (The *crash* point counts issued instructions, so its exact
victim may shift between runs — recovery correctness never depends on it.)

The error taxonomy raised by the resilient transport and the watchdog also
lives here, as does :func:`run_with_restarts`, the bounded-restart
supervision loop shared by ``runtime.elastic.ElasticTrainer`` (macro JAX
loop) and ``Runtime.run_supervised`` (scheduler core).  Keeping it here —
dependency-free — lets the core supervise itself without importing the
jax-backed training stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Mapping, NamedTuple, Optional, Sequence

_M64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    """splitmix64-style avalanche over a tuple of ints (order-sensitive).

    Explicit integer mixing instead of Python ``hash()`` — the builtin is
    salted per process for strings and would break cross-run replay.
    """
    x = 0x9E3779B97F4A7C15
    for v in vals:
        v = (v & _M64) * 0xBF58476D1CE4E5B9 & _M64
        v ^= v >> 27
        x = (x ^ v) * 0x94D049BB133111EB & _M64
        x ^= x >> 31
    return x


def _u01(*vals: int) -> float:
    return _mix(*vals) / float(1 << 64)


class WireFate(NamedTuple):
    """The plan's verdict for one delivery attempt of one message."""
    drop: bool
    delay_s: float       # 0.0 = deliver immediately
    duplicate: bool


_OK = WireFate(False, 0.0, False)


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable chaos schedule.

    Wire-fault probabilities apply per *delivery attempt* — a retransmit of a
    dropped message re-rolls with ``attempt+1``, so no message is dropped
    forever.  ``crash`` maps node -> 1-based issued-instruction index at
    which that rank fail-stops silently (no abort broadcast: peers must
    detect it via watchdog + heartbeat staleness).  ``slow`` maps node ->
    seconds added to every kernel/host-task execution on that rank.
    """

    seed: int = 0
    drop: float = 0.0            # P(payload attempt silently dropped)
    delay: float = 0.0           # P(payload delivery delayed)
    delay_s: float = 0.02        # max delay; actual is deterministic in [1/4, 1]x
    duplicate: float = 0.0       # P(an extra copy of the payload is delivered)
    reorder: float = 0.0         # P(payload held briefly so later sends pass it)
    reorder_s: float = 0.002
    pilot_drop: float = 0.0      # pilots are unacked metadata: dropped = lost
    crash: Mapping[int, int] = field(default_factory=dict)
    slow: Mapping[int, float] = field(default_factory=dict)

    # -- queries -------------------------------------------------------------
    def has_wire_faults(self) -> bool:
        return any(p > 0.0 for p in (self.drop, self.delay, self.duplicate,
                                     self.reorder, self.pilot_drop))

    def _key(self, transfer_id: Optional[Sequence], msg_id: Optional[int]) -> tuple:
        tid = tuple(-1 if v is None else int(v)
                    for v in (transfer_id or ()))
        return (self.seed, len(tid), *tid, -1 if msg_id is None else int(msg_id))

    def payload_fate(self, transfer_id, msg_id, attempt: int = 1) -> WireFate:
        if not self.has_wire_faults():
            return _OK
        k = self._key(transfer_id, msg_id) + (attempt,)
        drop = self.drop > 0.0 and _u01(*k, 1) < self.drop
        dup = self.duplicate > 0.0 and _u01(*k, 2) < self.duplicate
        delay_s = 0.0
        if self.delay > 0.0 and _u01(*k, 3) < self.delay:
            delay_s = self.delay_s * (0.25 + 0.75 * _u01(*k, 4))
        elif self.reorder > 0.0 and _u01(*k, 5) < self.reorder:
            delay_s = self.reorder_s
        if not (drop or dup or delay_s):
            return _OK
        return WireFate(drop, delay_s, dup)

    def pilot_dropped(self, transfer_id, msg_id) -> bool:
        return (self.pilot_drop > 0.0
                and _u01(*self._key(transfer_id, msg_id), 6) < self.pilot_drop)

    def crash_point(self, node: int) -> Optional[int]:
        return self.crash.get(node)

    def slow_s(self, node: int) -> float:
        return self.slow.get(node, 0.0)

    def survivors(self) -> "FaultPlan":
        """The plan for a restarted grid: crash faults already fired (they
        are one-shot, like ``ElasticTrainer``'s transient injection); wire
        and slow faults persist."""
        return replace(self, crash={})


# -- failure taxonomy ---------------------------------------------------------
class FaultError(RuntimeError):
    """Base of all transport/execution fault errors."""


class TransportError(FaultError):
    """A reliable send exhausted its retransmit budget without an ack."""


class InjectedCrash(FaultError):
    """Recorded locally by a rank fail-stopped by the fault plan.  Never
    broadcast — a crashed rank is silent; peers must *detect* it."""


class NodeFailure(FaultError):
    """Raised by the watchdog: progress stalled past the deadline.

    Carries the stuck instruction and the peers whose heartbeats went stale,
    so ``wait_epoch`` failures name a culprit instead of timing out blind.
    """

    def __init__(self, node: int, stuck: str, dead_peers: Sequence[int],
                 detail: str = ""):
        self.node = node
        self.stuck = stuck
        self.dead_peers = tuple(dead_peers)
        peers = (f"; suspect dead peer(s) {', '.join(f'N{p}' for p in self.dead_peers)}"
                 if self.dead_peers else "")
        super().__init__(
            f"watchdog on N{node}: no progress, stuck at {stuck}{peers}"
            + (f"; {detail}" if detail else ""))


class PeerAborted(FaultError):
    """Received an EPOCH_ABORT poison broadcast from a failing peer."""

    def __init__(self, node: int, origin: int, dead_peer: Optional[int],
                 instruction: str, cause: str):
        self.node = node
        self.origin = origin
        self.dead_peer = dead_peer
        self.instruction = instruction
        self.cause = cause
        dead = f" (dead peer N{dead_peer})" if dead_peer is not None else ""
        super().__init__(
            f"N{node}: epoch aborted by N{origin}{dead} at {instruction}: {cause}")


class EpochTimeoutError(TimeoutError):
    """``wait_epoch`` deadline expired; message carries the stall report."""


class ExecutionAborted(RuntimeError):
    """Raised by ``Runtime.sync`` on any executor failure.

    Aggregates the *first* error of every failed executor plus the
    communicator's pending-transfer state, so a CI failure is diagnosable
    from the exception text alone.
    """

    def __init__(self, summary: str, failures: Sequence[tuple[int, BaseException]]):
        self.failures = list(failures)
        lines = [summary]
        for node, err in self.failures:
            lines.append(f"  N{node}: {type(err).__name__}: {err}")
        super().__init__("\n".join(lines))


# -- bounded-restart supervision ---------------------------------------------
def run_with_restarts(attempt: Callable[[int], object],
                      on_failure: Callable[[BaseException, int], None],
                      *, max_restarts: int = 3,
                      recoverable: tuple = (RuntimeError, TimeoutError)):
    """Run ``attempt(restarts)`` until it returns, restarting on failure.

    ``on_failure(err, restarts)`` runs between attempts (shrink the grid,
    restore a snapshot, clear one-shot faults).  After ``max_restarts``
    failed recoveries the last error propagates.  Returns
    ``(result, restarts)``.
    """
    restarts = 0
    while True:
        try:
            return attempt(restarts), restarts
        except recoverable as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            on_failure(e, restarts)
