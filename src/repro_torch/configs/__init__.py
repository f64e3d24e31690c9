# Copied from src/repro/configs/__init__.py, with imports from repro_torch.
"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published config; ``get_config(name,
reduced=True)`` returns the smoke-test-sized variant of the same family.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCHITECTURES = [
    "starcoder2_3b",
    "minitron_4b",
    "h2o_danube_1_8b",
    "qwen2_1_5b",
    "granite_moe_1b_a400m",
    "granite_moe_3b_a800m",
    "zamba2_7b",
    "mamba2_370m",
    "whisper_tiny",
    "internvl2_26b",
]

# canonical CLI ids (dash form) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}
ALIASES.update({
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-1.5b": "qwen2_1_5b",
})

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# archs that support long_500k (sub-quadratic attention path); pure
# full-attention archs skip it — recorded in DESIGN.md §Arch-applicability
LONG_CONTEXT_OK = {"h2o_danube_1_8b", "zamba2_7b", "mamba2_370m"}


def get_config(name: str, *, reduced: bool = False) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def cells(arch: str) -> list[str]:
    """Shape names applicable to ``arch`` (all 4 unless long_500k is skipped
    for a pure full-attention family — still 40 total across the pool since
    the spec counts 4 shapes per arch; inapplicable ones are *reported* as
    skipped in the dry-run table)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if ALIASES.get(arch, arch).replace("-", "_") in LONG_CONTEXT_OK:
        out.append("long_500k")
    return out


ALL_CELLS = [(a, s) for a in ARCHITECTURES for s in SHAPES]
