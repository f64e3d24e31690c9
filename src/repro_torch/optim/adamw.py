"""AdamW over the port's parameter tree, a dict of name -> tensor.

The PyTorch counterpart of ``src/repro/optim/adamw.py`` (``adamw_init`` and
``adamw_update``): ``state = {m, v, step}`` with f32 moments, a global-norm
clip, and the grad norm returned.  Where the JAX version returns new trees,
this one updates the parameters and the moments in place, one tensor at a
time, so a step holds no second copy of the model (25 GB of parameters,
gradients and moments at qwen2-1.5b's full width).
"""

from __future__ import annotations

import numpy as np
import torch


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
