"""The modules of ``repro_torch.core`` that are the JAX package's own code.

Fifteen modules of ``src/repro_torch/core/`` are copies of
``src/repro/core/``: the region algebra, the task, command and instruction
graphs, the allocator, lookahead, the verifier, the fault plans and the DOT
export.  Every check that holds the port's instruction graph equal to the
reference's rests on that, so each copy is held to its source here: a
first line that names the source, then the source byte for byte.
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
VERBATIM = ("region", "range_mapper", "reduction", "buffer", "task_graph",
            "command_graph", "collective", "instructions", "instruction_graph",
            "allocation", "memory", "lookahead", "verify", "faults", "dot")


@pytest.mark.parametrize("module", VERBATIM)
def test_port_module_is_a_verbatim_copy(module):
    source = (ROOT / "src" / "repro" / "core" / f"{module}.py").read_bytes()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{module}.py").read_bytes()
    first, _, rest = port.partition(b"\n")
    assert first == f"# Copied from src/repro/core/{module}.py.".encode()
    assert rest == source, f"core/{module}.py differs from its source"
