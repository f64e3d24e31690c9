"""Nothing under ``portbench/`` imports JAX, the JAX package ``repro`` or
the JAX package's ``benchmarks``, compared by whole top-level names, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = top_level_imports(f) & FORBIDDEN
        assert not bad, f"{f} imports {bad}"


def test_whole_names_compared():
    # the port's name begins with the JAX package's, and is allowed
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".")[0] != "repro"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert not top_level_imports(f) & (FORBIDDEN | {"repro_torch"}), f
