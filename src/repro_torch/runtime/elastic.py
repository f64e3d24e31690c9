# Copied from src/repro/runtime/elastic.py, with imports from repro_torch.
"""Fault tolerance and elasticity for the macro training loop.

``ElasticTrainer`` wraps ``TrainLoop`` in a supervision loop: a step failure
(node loss, injected fault) triggers (1) rebuilding the device mesh from the
surviving hosts, (2) restoring the newest committed checkpoint — stored
logically-global, so restoring onto a *different* mesh shape is just a
device_put with the new shardings — and (3) resuming from that step.  The
data pipeline is a pure function of (seed, step), so the token stream is
bit-identical across restarts and reshards.

``rebalance_weights`` consumes the executor's per-queue EWMA latency report
(micro runtime) and produces new work-split weights — persistent stragglers
get proportionally smaller chunks on the next split (paper §4.1 latency
sensitivity, applied as mitigation).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.faults import run_with_restarts
from .train_loop import TrainMetrics


class ElasticTrainer:
    def __init__(self, make_loop, *, max_restarts: int = 3):
        """``make_loop(world_size) -> TrainLoop`` — the factory is re-invoked
        with the surviving world size after every failure."""
        self.make_loop = make_loop
        self.max_restarts = max_restarts

    def run(self, num_steps: int, *, world_size: int = 4,
            fail_at: Optional[int] = None,
            lose_nodes_on_failure: int = 1) -> tuple[dict, TrainMetrics, int]:
        # one TrainMetrics for the whole supervised run: ``loop.run``
        # mutates it in place, so progress survives across restarts
        metrics = TrainMetrics()
        ctx = {"world": world_size, "fail_at": fail_at}

        def attempt(restarts: int) -> dict:
            loop = self.make_loop(ctx["world"])
            start, state = loop.restore_or_init()
            remaining = num_steps - start
            if remaining <= 0:
                return state
            _, state, _ = loop.run(remaining, start_step=start, state=state,
                                   metrics=metrics, fail_at=ctx["fail_at"])
            return state

        def on_failure(err: BaseException, restarts: int) -> None:
            metrics.restarts = restarts
            # a failure costs us nodes: rebuild smaller and restore
            ctx["world"] = max(1, ctx["world"] - lose_nodes_on_failure)
            ctx["fail_at"] = None   # the fault was transient

        state, _ = run_with_restarts(attempt, on_failure,
                                     max_restarts=self.max_restarts,
                                     recoverable=(RuntimeError,))
        return state, metrics, ctx["world"]


def rebalance_weights(report: dict[str, float],
                      *, floor: float = 0.25) -> dict[str, float]:
    """Inverse-latency work weights from a straggler report.

    ``report`` maps queue name -> EWMA seconds per instruction.  Returns
    normalized weights; a queue twice as slow gets half the work, floored so
    no device is starved entirely.
    """
    lanes = {k: v for k, v in report.items() if k.startswith("device")}
    if not lanes:
        return {}
    inv = {k: 1.0 / max(v, 1e-9) for k, v in lanes.items()}
    mean = sum(inv.values()) / len(inv)
    weights = {k: max(v / mean, floor) for k, v in inv.items()}
    total = sum(weights.values())
    return {k: v * len(weights) / total for k, v in weights.items()}
