"""Carry the JAX package's parameters into the port.

``model_from_numpy`` takes the tree that the JAX model's ``init`` returns
(``repro.models.build_model(cfg).init``), as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, ...)``), and returns the port's model of
``cfg.family`` holding the same values: ``DecoderLM`` (dense), ``Mamba2LM``
(ssm) or ``Zamba2LM`` (hybrid, which also carries the ``shared`` block).
The JAX tree stacks the layers' arrays along a leading ``[L, ...]`` axis;
the port keeps one parameter tree per layer.  Layouts are the same (a
linear weight is ``[d_in, d_out]``), so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build_model
from .config import ArchConfig


def _tensors(obj, device, index=None):
    if isinstance(obj, dict):
        return {k: _tensors(v, device, index) for k, v in obj.items()}
    a = np.asarray(obj)
    return torch.from_numpy(np.array(a if index is None else a[index])).to(device)


def model_from_numpy(cfg: ArchConfig, params: dict, device="cuda"):
    top = {k: _tensors(v, device) for k, v in params.items() if k != "layers"}
    layers = [_tensors(params["layers"], device, i)
              for i in range(cfg.num_layers)]
    return build_model(cfg).load(top, layers)
