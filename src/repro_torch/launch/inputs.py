"""Model inputs: real batches for smoke tests and training on the port.

The PyTorch counterpart of ``train_batch`` in ``src/repro/launch/inputs.py``;
its ``ShapeDtypeStruct`` stand-ins belong to the dry-run (ROADMAP A20).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import D_VIS
from repro_torch.models import ArchConfig


def train_batch(cfg: ArchConfig, batch: int, seq: int, *, rng=None,
                device="cuda") -> dict:
    """A training batch on ``device``, drawn with numpy as the JAX package
    draws it (the same ``rng`` gives the same tokens)."""
    rng = rng or np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    t = torch.from_numpy(toks).to(device)
    out = {"tokens": t, "labels": t}
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.enc_frames, cfg.d_model))).to(
                device, cfg.adt)
    if cfg.family == "vlm":
        out["vis"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.vis_tokens, D_VIS))).to(device, cfg.adt)
    return out
