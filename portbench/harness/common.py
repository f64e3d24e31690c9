"""Pieces every loop and application shares: the observation a run fills,
the run-ahead limit of a submitting thread, spans, and reading state."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Observation:
    """What one run of a cell saw.  Metric readers take it."""
    cell: str
    config: dict
    traffic: dict
    cards: int                      # physical cards the run uses
    setup_s: float = 0.0
    window_s: float = 0.0           # host clock, first submission to sync
    units: int = 0                  # steps or windows completed in it
    latencies_s: list = field(default_factory=list)   # served windows
    counters: dict = field(default_factory=dict)      # deltas over window
    peak_bytes: int = 0             # fullest card, set-up and window
    timeline: Optional[object] = None                 # harness.trace


def span(name: str, on: bool = True):
    """A span of the harness's own, which the profiler of a traced run sees;
    a no-op context when ``on`` is false (nothing profiles)."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(f"portbench.{name}")


def wait_for_room(rt, max_tasks: int) -> None:
    """Hold the submitting thread while any node's scheduler has more than
    ``max_tasks`` tasks waiting to be lowered.  A simulation that submits
    its whole run at once would fill the queue; a run that is cut by time
    would then end long after its window.  The schedulers bound how far
    they run ahead of the executors themselves."""
    while max(s.inbox.qsize() for s in rt.schedulers) > max_tasks:
        time.sleep(0.0005)


def peak_bytes(device) -> int:
    """``torch.cuda.max_memory_allocated`` of the fullest card."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))


def host(t) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()

