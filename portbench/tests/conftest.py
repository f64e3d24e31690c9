"""Puts the checkout's root and ``src/`` on the path, so the tests import
``portbench`` and the program as the benchmark does."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
