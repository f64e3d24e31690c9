# Copied from src/repro/core/dot.py.
"""Graphviz DOT export for the three scheduling IRs (DESIGN.md §14.5).

``tdag_to_dot`` / ``cdag_to_dot`` / ``idag_to_dot`` render the task,
command and instruction graphs; ``idag_to_dot`` accepts the per-node
streams of the whole grid and draws one cluster per node with dashed
cross-node wait edges (send -> matching receive, merged on transfer id).
Verification failures from the schedule sanitizer (core/verify.py) can be
passed in to highlight the offending instructions in red — so a flagged
pair is debuggable visually instead of by iid archaeology.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .instructions import Instruction, InstructionType
from .task_graph import DepKind

_DEP_STYLE = {
    DepKind.TRUE: "solid",
    DepKind.ANTI: "dashed",
    DepKind.OUTPUT: "dotted",
    DepKind.SYNC: "bold",
}

_ITYPE_FILL = {
    InstructionType.ALLOC: "#d5e8d4",
    InstructionType.FREE: "#f8cecc",
    InstructionType.SPILL: "#ffe6cc",
    InstructionType.RELOAD: "#ffe6cc",
    InstructionType.SEND: "#dae8fc",
    InstructionType.RECEIVE: "#dae8fc",
    InstructionType.SPLIT_RECEIVE: "#dae8fc",
    InstructionType.AWAIT_RECEIVE: "#dae8fc",
    InstructionType.COLL_SEND: "#dae8fc",
    InstructionType.COLL_RECV: "#dae8fc",
    InstructionType.GATHER_RECEIVE: "#dae8fc",
    InstructionType.HORIZON: "#e1d5e7",
    InstructionType.EPOCH: "#e1d5e7",
}


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def tdag_to_dot(tdag, *, title: str = "TDAG") -> str:
    """Render a :class:`~repro.core.task_graph.TaskGraph`."""
    out = [f'digraph "{_esc(title)}" {{', '  rankdir=TB;',
           '  node [shape=box, style=filled, fillcolor="#ffffff"];']
    for t in tdag.tasks:
        label = f"T{t.tid} {t.name}\\n{t.ttype.name.lower()}"
        out.append(f'  t{t.tid} [label="{_esc(label)}"];')
    for t in tdag.tasks:
        for d, k in t.dependencies:
            out.append(f'  t{d.tid} -> t{t.tid} '
                       f'[style={_DEP_STYLE.get(k, "solid")}];')
    out.append("}")
    return "\n".join(out) + "\n"


def cdag_to_dot(commands, *, title: str = "CDAG") -> str:
    """Render a command list (one node-cluster per rank)."""
    out = [f'digraph "{_esc(title)}" {{', '  rankdir=TB;',
           '  node [shape=box, style=filled, fillcolor="#ffffff"];']
    by_node: dict[int, list] = {}
    for c in commands:
        by_node.setdefault(c.node, []).append(c)
    for n in sorted(by_node):
        out.append(f'  subgraph cluster_n{n} {{ label="N{n}";')
        for c in by_node[n]:
            t = f" T{c.task.tid}" if c.task is not None else ""
            label = f"C{c.cid} {c.ctype.value}{t}"
            out.append(f'    c{c.cid} [label="{_esc(label)}"];')
        out.append("  }")
    for c in commands:
        for d, k in c.dependencies:
            out.append(f'  c{d.cid} -> c{c.cid} '
                       f'[style={_DEP_STYLE.get(k, "solid")}];')
    out.append("}")
    return "\n".join(out) + "\n"


def idag_to_dot(node_instrs: Sequence[Sequence[Instruction]], *,
                issues: Iterable = (), title: str = "IDAG",
                max_label: int = 48) -> str:
    """Render merged per-node instruction streams, one cluster per rank.

    ``issues`` is an iterable of
    :class:`~repro.core.verify.VerificationIssue`; every instruction an
    issue names is filled red and annotated with the issue kind, and
    cross-node send/receive pairs are linked with dashed wait edges so a
    flagged ordering hole shows up as a visibly unconnected pair.
    """
    flagged: dict[int, str] = {}
    for iss in issues:
        for iid in iss.instrs:
            flagged.setdefault(iid, iss.kind)
    out = [f'digraph "{_esc(title)}" {{', '  rankdir=TB;',
           '  node [shape=box, style=filled, fillcolor="#ffffff"];']
    present: set[int] = set()
    recv_by_tid: dict[tuple, list[Instruction]] = {}
    for n, instrs in enumerate(node_instrs):
        out.append(f'  subgraph cluster_n{n} {{ label="N{n}";')
        for i in instrs:
            present.add(i.iid)
            label = f"I{i.iid} {i.itype.value}"
            if i.name:
                label += f"\\n{i.name[:max_label]}"
            attrs = [f'label="{_esc(label)}"']
            kind = flagged.get(i.iid)
            if kind is not None:
                attrs.append('fillcolor="#ff9999"')
                attrs.append(f'xlabel="{_esc(kind)}"')
            else:
                fill = _ITYPE_FILL.get(i.itype)
                if fill:
                    attrs.append(f'fillcolor="{fill}"')
            out.append(f'    i{i.iid} [{", ".join(attrs)}];')
            if i.itype in (InstructionType.RECEIVE,
                           InstructionType.SPLIT_RECEIVE,
                           InstructionType.GATHER_RECEIVE,
                           InstructionType.COLL_RECV):
                recv_by_tid.setdefault((n, i.transfer_id), []).append(i)
        out.append("  }")
    for instrs in node_instrs:
        for i in instrs:
            for d, k in i.dependencies:
                if d.iid in present:
                    out.append(f'  i{d.iid} -> i{i.iid} '
                               f'[style={_DEP_STYLE.get(k, "solid")}];')
    # cross-node wait edges: send -> every receive candidate on the target
    for instrs in node_instrs:
        for i in instrs:
            if i.itype not in (InstructionType.SEND,
                               InstructionType.COLL_SEND):
                continue
            for r in recv_by_tid.get((i.dest, i.transfer_id), ()):
                out.append(f'  i{i.iid} -> i{r.iid} '
                           f'[style=dashed, color="#3366cc", '
                           f'constraint=false];')
    out.append("}")
    return "\n".join(out) + "\n"


def write_dot(path: str, text: str) -> str:
    """Write DOT ``text`` to ``path`` and return the path (CLI helper)."""
    with open(path, "w") as f:
        f.write(text)
    return path


__all__ = ["tdag_to_dot", "cdag_to_dot", "idag_to_dot", "write_dot"]
