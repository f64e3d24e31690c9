"""Carry the JAX package's parameters into the port.

``model_from_numpy`` takes the tree that the JAX model's ``init`` returns
(``repro.models.build_model(cfg).init``), as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, ...)``), and returns the port's model of
``cfg.family`` holding the same values: ``DecoderLM`` (dense, moe),
``Mamba2LM`` (ssm), ``Zamba2LM`` (hybrid, which also carries the ``shared``
block), ``WhisperModel`` (audio: the ``enc`` and ``dec`` stacks) or
``InternVLModel`` (vlm: the nested ``lm`` tree and ``proj``).  The JAX tree
stacks the layers' arrays along a leading ``[L, ...]`` axis; the port keeps
one parameter tree per layer.  Layouts are the same (a linear weight is
``[d_in, d_out]``), so nothing is transposed.
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


def _unstack(tree, n: int, device) -> list:
    return [_tensors(tree, device, i) for i in range(n)]


def _top(tree, device, stacks=("layers",)) -> dict:
    return {k: _tensors(v, device) for k, v in tree.items() if k not in stacks}


def model_from_numpy(cfg: ArchConfig, params: dict, device="cuda"):
    model = build_model(cfg)
    if cfg.family == "audio":
        return model.load(_top(params, device, ("enc", "dec")),
                          _unstack(params["enc"], cfg.enc_layers, device),
                          _unstack(params["dec"], cfg.num_layers, device))
    lm = params["lm"] if cfg.family == "vlm" else params
    top, layers = _top(lm, device), _unstack(lm["layers"], cfg.num_layers,
                                             device)
    if cfg.family == "vlm":
        return model.load(top, layers, _tensors(params["proj"], device))
    return model.load(top, layers)
