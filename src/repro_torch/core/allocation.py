# Copied from src/repro/core/allocation.py.
"""Allocation and memory-id model (paper §3.2) plus residency state.

Memory ids: ``M0`` = user-controlled host memory, ``M1`` = DMA-capable
(page-locked) host memory, ``M2+d`` = dedicated memory of device ``d``.
Concrete addresses only exist at execution time; the graph refers to
allocations by numeric *allocation ids*.

Residency/lifetime fields (``last_use``, ``evictable``) are maintained by
:class:`repro.core.memory.MemoryManager`, which owns the allocation
lifecycle: per-memory byte budgets, LRU eviction order and spill-to-host
chains under budget pressure.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from .region import Box

USER_HOST = 0    # M0
PINNED_HOST = 1  # M1


def device_memory(device: int) -> int:
    return 2 + device


def is_device_memory(mid: int) -> bool:
    return mid >= 2


def queue_for_mem(mid: int) -> tuple:
    """Executor queue affinity of memory operations in ``mid``."""
    if is_device_memory(mid):
        return ("device", mid - 2)
    return ("host",)


_alloc_ids = itertools.count(1)


@dataclass(eq=False)
class Allocation:
    """A backing allocation for a buffer subregion in one memory.

    Identity semantics (``eq=False``): every allocation has a unique ``aid``;
    comparing field-wise would recurse through ``alloc_instr``/``initial_data``.
    """

    mid: int
    bid: Optional[int]            # buffer id; None for scratch
    box: Box                      # buffer-space box this allocation backs
    dtype: object = "float64"     # numpy dtype of the backing array
    aid: int = field(default_factory=lambda: next(_alloc_ids))
    live: bool = True
    # residency state, owned by the MemoryManager:
    last_use: int = 0             # logical LRU clock of the last touch
    evictable: bool = True        # one-shot scratches opt out of eviction
    # the ALLOC instruction that materializes this allocation (wired by the
    # memory manager; dependencies of every user point at it)
    alloc_instr: Optional[object] = None
    # M0 allocations seeded from user data carry it for lazy materialization
    initial_data: Optional[object] = None
    # renaming (DESIGN.md §13): when this physical is retired to the free
    # pool, the readers/producers of its last buffer version are snapshotted
    # here; the next writer of the recycled physical anti-depends on them
    hazards: list = field(default_factory=list)

    def nbytes(self) -> int:
        import numpy as np
        return self.box.volume() * np.dtype(self.dtype).itemsize

    def offset_of(self, b: Box) -> tuple[int, ...]:
        """Offset of buffer-space box ``b`` inside this allocation."""
        if not self.box.contains(b):
            raise ValueError(f"{b} not contained in allocation {self.box}")
        return tuple(x - o for x, o in zip(b.min, self.box.min))

    def __repr__(self) -> str:
        return f"A{self.aid}<M{self.mid},B{self.bid},{self.box}>"
