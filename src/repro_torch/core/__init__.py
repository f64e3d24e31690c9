"""The port's Celerity-style runtime: TDAG -> CDAG -> IDAG scheduling with
lookahead, out-of-order execution on CUDA streams and receive arbitration.

The graph layers are copies of ``src/repro/core``; ``backend``,
``communicator``, ``executor`` and ``runtime`` are rewritten for torch, and
``memo`` is a copy edited where it touches device memory.
"""

from .allocation import Allocation, PINNED_HOST, USER_HOST, device_memory
from .buffer import (AccessMode, Accessor, VirtualBuffer, read, read_write,
                     write)
from .command_graph import Command, CommandGraphGenerator, CommandType, generate_cdag
from .executor import BoundsError, BufferView, Executor, ReductionView
from .faults import (EpochTimeoutError, ExecutionAborted, FaultError,
                     FaultPlan, InjectedCrash, NodeFailure, PeerAborted,
                     TransportError, run_with_restarts)
from .instruction_graph import (EpochAbort, IdagGenerator, Instruction,
                                InstructionType, Pilot)
from .memo import ServingRuntime, Tenant, WindowHandle, window_signature
from .memory import MemoryManager, MemoryStats, MemState
from .observability import (CriticalPathReport, Histogram, MetricsRegistry,
                            classify_wait, critical_path)
from .reduction import Reduction, ReductionOp, reduction
from .lookahead import LookaheadScheduler
from .range_mapper import (all_range, fixed, fixed_row, neighborhood,
                           one_to_one, rows_upto, slice_dim)
from .region import Box, Region, RegionMap, split_box
from .runtime import Runtime, SupervisedResult
from .task_graph import DepKind, Task, TaskGraph, TaskType
from .tracing import Tracer
from .dot import cdag_to_dot, idag_to_dot, tdag_to_dot
from .verify import (CampaignResult, Mutation, ScheduleVerifier,
                     VerificationError, VerificationIssue, VerificationReport,
                     mutate_one, run_mutation_campaign, verify_graph)

__all__ = [
    "Allocation", "PINNED_HOST", "USER_HOST", "device_memory",
    "AccessMode", "Accessor", "VirtualBuffer", "read", "read_write", "write",
    "Command", "CommandGraphGenerator", "CommandType", "generate_cdag",
    "BoundsError", "BufferView", "Executor", "ReductionView",
    "EpochTimeoutError", "ExecutionAborted", "FaultError", "FaultPlan",
    "InjectedCrash", "NodeFailure", "PeerAborted", "TransportError",
    "run_with_restarts",
    "EpochAbort", "IdagGenerator", "Instruction", "InstructionType", "Pilot",
    "ServingRuntime", "Tenant", "WindowHandle", "window_signature",
    "MemoryManager", "MemoryStats", "MemState",
    "CriticalPathReport", "Histogram", "MetricsRegistry",
    "classify_wait", "critical_path",
    "Reduction", "ReductionOp", "reduction",
    "LookaheadScheduler",
    "all_range", "fixed", "fixed_row", "neighborhood", "one_to_one",
    "rows_upto", "slice_dim",
    "Box", "Region", "RegionMap", "split_box",
    "Runtime", "SupervisedResult",
    "DepKind", "Task", "TaskGraph", "TaskType",
    "Tracer",
    "cdag_to_dot", "idag_to_dot", "tdag_to_dot",
    "CampaignResult", "Mutation", "ScheduleVerifier", "VerificationError",
    "VerificationIssue", "VerificationReport", "mutate_one",
    "run_mutation_campaign", "verify_graph",
]
