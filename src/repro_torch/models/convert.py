"""Carry the JAX package's parameters into the port.

``decoder_from_numpy`` takes the tree that ``repro.models.DecoderLM.init``
returns, as nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``),
and returns the port's module holding the same values.  The JAX tree stacks
the layers' arrays along a leading ``[L, ...]`` axis; the port keeps one
parameter tree per layer.  Layouts are the same (a linear weight is
``[d_in, d_out]``), so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import DecoderLM


def _tensors(obj, device, index=None):
    if isinstance(obj, dict):
        return {k: _tensors(v, device, index) for k, v in obj.items()}
    a = np.asarray(obj)
    return torch.from_numpy(np.array(a if index is None else a[index])).to(device)


def decoder_from_numpy(cfg: ArchConfig, params: dict,
                       device="cuda") -> DecoderLM:
    top = {k: _tensors(v, device) for k, v in params.items() if k != "layers"}
    layers = [_tensors(params["layers"], device, i)
              for i in range(cfg.num_layers)]
    return DecoderLM(cfg).load(top, layers)
