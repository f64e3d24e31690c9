"""Model inputs: real batches for smoke tests and training on the port, and
stand-ins for the dry-run that allocate nothing.

The PyTorch counterpart of ``src/repro/launch/inputs.py``.  Where the JAX
package returns ``ShapeDtypeStruct`` stand-ins, the ``*_specs`` functions
here return fake tensors, of the active ``FakeTensorMode`` (the dry-run
traces under one) or of a fresh one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# the models first: data.pipeline and the models import each other
from repro_torch.models import ArchConfig, build_model
from repro_torch.data.pipeline import D_VIS


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


def _faking():
    """The active fake mode's context, or a fresh ``FakeTensorMode``: the
    stand-ins are fake tensors either way (usable after the context)."""
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    return FakeTensorMode()


def train_batch_specs(cfg: ArchConfig, batch: int, seq: int, *,
                      device="cuda") -> dict:
    """Stand-ins for every train_step input."""
    with _faking():
        out = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                     device=device),
               "labels": torch.empty((batch, seq), dtype=torch.int32,
                                     device=device)}
        if cfg.family == "audio":
            out["frames"] = torch.empty((batch, cfg.enc_frames, cfg.d_model),
                                        dtype=cfg.adt, device=device)
        if cfg.family == "vlm":
            out["vis"] = torch.empty((batch, cfg.vis_tokens, D_VIS),
                                     dtype=cfg.adt, device=device)
    return out


def param_specs(cfg: ArchConfig, *, device="cuda"):
    """``(model, {name: parameter})``: the port's model with stand-in
    weights; ``init`` draws them as usual, but a fake draw is a shape
    only."""
    with _faking():
        model = build_model(cfg).init(torch.Generator(device=device))
    return model, dict(model.named_parameters())


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, *,
                device="cuda") -> dict:
    with _faking():
        return build_model(cfg).init_cache(batch, max_len, device=device)


def decode_ids_specs(batch: int, *, device="cuda") -> torch.Tensor:
    with _faking():
        return torch.empty((batch, 1), dtype=torch.int32, device=device)
