# Copied from src/repro/core/buffer.py.
"""Virtualized buffers and accessors (paper §2.2).

A ``VirtualBuffer`` has a global index space but no storage of its own —
storage materializes as per-memory backing *allocations* managed by the
instruction-graph generator.  ``Accessor`` bundles a buffer, an access mode
and a range mapper; it is the sole way kernels interact with buffers.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .range_mapper import RangeMapper
from .reduction import Reduction, reduction  # noqa: F401 — re-export: kernels
# bind reductions next to accessors, so both descriptors live in one namespace
from .region import Box, Region

_buffer_ids = itertools.count()


class AccessMode(enum.Enum):
    READ = "read"
    WRITE = "write"           # discard-write: previous contents dead
    READ_WRITE = "read_write"

    @property
    def is_producer(self) -> bool:
        return self in (AccessMode.WRITE, AccessMode.READ_WRITE)

    @property
    def is_consumer(self) -> bool:
        return self in (AccessMode.READ, AccessMode.READ_WRITE)


@dataclass
class VirtualBuffer:
    shape: tuple[int, ...]
    dtype: np.dtype = field(default_factory=lambda: np.dtype(np.float64))
    name: str = ""
    bid: int = field(default_factory=lambda: next(_buffer_ids))
    # host-side initial contents (optional); region initialized from user data
    initial_value: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.shape = tuple(int(s) for s in self.shape)
        self.dtype = np.dtype(self.dtype)
        if not self.name:
            self.name = f"B{self.bid}"
        if self.initial_value is not None:
            iv = np.asarray(self.initial_value, dtype=self.dtype)
            if iv.shape != self.shape:
                raise ValueError(f"initial value shape {iv.shape} != {self.shape}")
            self.initial_value = iv

    @property
    def full_box(self) -> Box:
        return Box.full(self.shape)

    @property
    def full_region(self) -> Region:
        return Region.from_box(self.full_box)

    def elem_bytes(self) -> int:
        return self.dtype.itemsize

    def __hash__(self) -> int:
        return self.bid

    def __repr__(self) -> str:
        return f"VirtualBuffer({self.name}, shape={self.shape}, dtype={self.dtype})"


@dataclass(frozen=True)
class Accessor:
    buffer: VirtualBuffer
    mode: AccessMode
    range_mapper: RangeMapper

    def mapped_region(self, chunk: Box) -> Region:
        return self.range_mapper(chunk, self.buffer.shape)


def read(buffer: VirtualBuffer, rm: RangeMapper) -> Accessor:
    return Accessor(buffer, AccessMode.READ, rm)


def write(buffer: VirtualBuffer, rm: RangeMapper) -> Accessor:
    return Accessor(buffer, AccessMode.WRITE, rm)


def read_write(buffer: VirtualBuffer, rm: RangeMapper) -> Accessor:
    return Accessor(buffer, AccessMode.READ_WRITE, rm)
