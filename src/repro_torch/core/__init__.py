"""The port's Celerity-style runtime: TDAG -> CDAG -> IDAG scheduling with
lookahead, out-of-order execution on CUDA streams and receive arbitration.

The graph layers are copies of ``src/repro/core``; ``backend``,
``communicator``, ``executor`` and ``runtime`` are rewritten for torch.
"""

from .buffer import read, read_write, reduction, write
from .executor import BoundsError, BufferView, Executor
from .faults import ExecutionAborted, FaultPlan
from .range_mapper import all_range, neighborhood, one_to_one
from .region import Box
from .runtime import Runtime

__all__ = [
    "read", "read_write", "reduction", "write",
    "BoundsError", "BufferView", "Executor",
    "ExecutionAborted", "FaultPlan",
    "all_range", "neighborhood", "one_to_one",
    "Box",
    "Runtime",
]
