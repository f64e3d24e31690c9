"""The port's Celerity-style runtime: TDAG -> CDAG -> IDAG scheduling with
lookahead, out-of-order execution on CUDA streams and receive arbitration.

The graph layers are copies of ``src/repro/core``; ``backend``,
``communicator``, ``executor`` and ``runtime`` are rewritten for torch.
"""

from .buffer import read, read_write, write
from .executor import BoundsError, BufferView, Executor, ReductionView
from .faults import ExecutionAborted, FaultPlan
from .range_mapper import all_range, fixed, neighborhood, one_to_one
from .reduction import reduction
from .region import Box, Region
from .runtime import Runtime

__all__ = [
    "read", "read_write", "reduction", "write",
    "BoundsError", "BufferView", "Executor", "ReductionView",
    "ExecutionAborted", "FaultPlan",
    "all_range", "fixed", "neighborhood", "one_to_one",
    "Box", "Region",
    "Runtime",
]
