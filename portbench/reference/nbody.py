"""Plain reference of one N-body step (Listing 1 of the paper).

Softened all-pairs gravity with unit masses in the force sum:

    F_i = sum_j (p_j - p_i) / (|p_j - p_i|^2 + soft)^(3/2)
    V'  = V + mass * F * dt
    P'  = P + V' * dt

computed in float64 from the given state, in blocks of rows so that the
``[rows, N]`` temporaries fit.  ``|p_j - p_i|^2`` is expanded as
``|p_i|^2 + |p_j|^2 - 2 p_i.p_j``: in float64 its rounding (about 1e-15 of
``|p|^2``) is far below the softening, and the expansion turns the two
largest passes into matrix products.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

# elements of one [rows, N] float64 temporary: 4 GiB
_BLOCK_ELEMENTS = 1 << 29


def forces(p: torch.Tensor, soft: float = 1e-3) -> torch.Tensor:
    """Forces ``[N, 3]`` on every body of ``p`` ``[N, 3]``, in float64."""
    p = p.to(torch.float64)
    n = p.shape[0]
    norms = (p * p).sum(1)
    out = torch.empty_like(p)
    rows = max(1, _BLOCK_ELEMENTS // max(n, 1))
    for b in range(0, n, rows):
        e = min(n, b + rows)
        pi = p[b:e]
        # r2 = |p_i|^2 + |p_j|^2 - 2 p_i.p_j + soft
        r2 = torch.addmm(norms[None, :], pi, p.T, alpha=-2.0)
        r2.add_(norms[b:e, None]).add_(soft)
        w = r2.rsqrt_()
        w.mul_(w * w)                                  # 1 / r^3
        # sum_j w_ij (p_j - p_i) = (w @ p)_i - p_i sum_j w_ij
        out[b:e] = w @ p - pi * w.sum(1, keepdim=True)
        del r2, w
    return out


def step(P: torch.Tensor, V: torch.Tensor, dt: float, mass: float,
         soft: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """One step from ``(P, V)``; returns ``(P', V')`` in float64."""
    P64, V64 = P.to(torch.float64), V.to(torch.float64)
    V1 = V64 + mass * forces(P64, soft) * dt
    return P64 + V1 * dt, V1


def forces_lower(p: torch.Tensor, dtype: torch.dtype, soft: float = 1e-3
                 ) -> torch.Tensor:
    """Forces ``[N, 3]`` in float32 with every pair term worked out in
    ``dtype``: the positions rounded to it, then the differences, ``r^2``
    (fused multiply-adds, one rounding each), ``rsqrt``, ``1 / r^3`` and
    the pair terms in ``dtype``, summed in float32, as a kernel that
    computes in ``dtype`` and accumulates in float32 would."""
    pl = p.to(dtype)
    n = p.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    rows = max(1, _BLOCK_ELEMENTS // max(n, 1))
    for b in range(0, n, rows):
        e = min(n, b + rows)
        d = [pl[None, :, k] - pl[b:e, k, None] for k in range(3)]
        w = d[0] * d[0]
        w.addcmul_(d[1], d[1]).addcmul_(d[2], d[2]).add_(soft).rsqrt_()
        w.mul_(w * w)                                  # 1 / r^3
        for k in range(3):
            out[b:e, k] = d[k].mul_(w).sum(1, dtype=torch.float32)
        del d, w
    return out


def step_pairs_lower(P: torch.Tensor, V: torch.Tensor, dt: float,
                     mass: float, dtype: torch.dtype, soft: float = 1e-3
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step with the pair terms in ``dtype`` (``forces_lower``) and the
    state and update in float32.  A control of the benchmark."""
    P32, V32 = P.to(torch.float32), V.to(torch.float32)
    V1 = V32 + forces_lower(P32, dtype, soft) * (mass * dt)
    return P32 + V1 * dt, V1


def step_state_lower(P: torch.Tensor, V: torch.Tensor, dt: float,
                     mass: float, dtype: torch.dtype, soft: float = 1e-3
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float64 step with the state held in ``dtype``: the inputs and
    each result rounded to it.  A control of the benchmark."""
    P1, V1 = step(P.to(dtype), V.to(dtype), dt, mass, soft)
    V1 = V1.to(dtype)
    P1 = (P.to(dtype).to(torch.float64) + V1.to(torch.float64) * dt).to(dtype)
    return P1, V1
