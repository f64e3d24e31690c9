"""AdamW over the port's parameter tree, a dict of name -> tensor.

The PyTorch counterpart of ``src/repro/optim/adamw.py`` (``adamw_init`` and
``adamw_update``): ``state = {m, v, step}`` with f32 moments, a global-norm
clip, and the grad norm returned.  Where the JAX version returns new trees,
this one updates the parameters and the moments in place, one tensor at a
time, so a step holds no second copy of the model (25 GB of parameters,
gradients and moments at qwen2-1.5b's full width).

``zero1_shardings`` gives the moments ZeRO-1 placements: each
data-parallel rank keeps only its shard of ``m`` and ``v``.  On DTensor
parameters the in-place update then reduce-scatters the gradients into the
moments' shards and all-gathers the update into the parameters.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.sharding.partition import NamedSharding, axis_size, data_axes
from repro_torch.sharding.rules import param_shardings


def adamw_init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One step: ``(params, state, grad_norm)``; a missing gradient counts as
    zeros.  The bias corrections ``1 - b ** step`` are taken in f32, as the
    JAX version takes them."""
    step = state["step"] + 1
    leaves = [g for g in grads.values() if g is not None]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(grad_clip / (gn + 1e-9), max=1.0)
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    for k, p in params.items():
        g = grads.get(k)
        g = (torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float()) * scale
        m, v = state["m"][k], state["v"][k]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        pf = p.float()
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, gn


_STACKED = re.compile(r"(.*?\b(?:layers|enc|dec))\.(\d+)\.")


def _stack_depths(names) -> dict:
    """``{stack prefix: layers}`` of per-layer names (``layers.3.attn...``,
    Whisper's ``enc.0...`` and ``dec.0...``, InternVL's ``lm.layers...``)."""
    depth: dict = {}
    for name in names:
        m = _STACKED.match(name)
        if m:
            depth[m.group(1)] = max(depth.get(m.group(1), 0),
                                    int(m.group(2)) + 1)
    return depth


def zero1_shardings(params: dict, mesh) -> dict:
    """Shardings for the optimizer state: params' TP sharding PLUS data-axis
    sharding on the largest still-unsharded divisible dim (ZeRO-1).

    The reference's stacked ``[L, ...]`` moments count the layer axis as a
    candidate (first, so it wins ties).  Where it would win, the reference
    spreads whole layers over the data ranks, which one tree per layer
    cannot express: such a per-layer moment stays unsharded over data, so
    each spec equals the reference's without its leading entry.  The
    port's ``step`` is a Python int; its replicated entry mirrors the
    reference's."""
    pshard = param_shardings(params, mesh)
    dp = data_axes(mesh)
    dp_size = axis_size(mesh, dp)
    depths = _stack_depths(params)

    def one(name, shape, ns):
        spec = list(ns.spec) + [None] * (len(shape) - len(ns.spec))
        # choose the largest unsharded dim divisible by the data axes
        best, best_dim = -1, None
        m = _STACKED.match(name)
        if m and depths[m.group(1)] % dp_size == 0:
            best, best_dim = depths[m.group(1)], "layers"
        for i, (dim, s) in enumerate(zip(shape, spec)):
            if s is None and dim % dp_size == 0 and dim > best:
                best, best_dim = dim, i
        if best_dim not in (None, "layers") and dp:
            spec[best_dim] = dp if len(dp) > 1 else dp[0]
        return NamedSharding(mesh, tuple(spec))

    moments = {k: one(k, tuple(p.shape), pshard[k]) for k, p in params.items()}
    return {"m": moments, "v": moments, "step": NamedSharding(mesh, ())}
