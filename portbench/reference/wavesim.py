"""Plain reference of the 5-point wave loop (WaveSim), on sampled patches.

One step over an ``H x W`` field, with ``c`` the squared Courant number:

    un[i, j] = 2 u[i, j] - um[i, j]
               + c (u[i-1, j] + u[i+1, j] + u[i, j-1] + u[i, j+1] - 4 u[i, j])

on the interior ``0 < i < H - 1``, ``0 < j < W - 1``, and 0 on the border
(Dirichlet); then ``um, u = u, un``.

After ``k`` steps a cell depends only on the cells within ``k`` rows and
columns of it in the two initial fields, so a ``P x P`` patch of the field
after ``k`` steps is computed from the ``(P + 2k)^2`` block around it,
which shrinks by one cell on each side a step.  Cells of that block that lie
outside the field are 0 and stay 0, as the border does.  The 3 x 3 stencil
runs as a ``conv2d`` without padding over a batch of patches; the caller
turns TF32 off.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def initial_block(field: np.ndarray, r0: int, q0: int, size: int,
                  reach: int) -> np.ndarray:
    """The ``(size + 2 reach)^2`` block of ``field`` around the patch at
    ``(r0, q0)``, with 0 where it lies outside the field."""
    H, W = field.shape
    n = size + 2 * reach
    out = np.zeros((n, n), dtype=field.dtype)
    a0, a1 = r0 - reach, r0 + size + reach
    b0, b1 = q0 - reach, q0 + size + reach
    ra0, ra1 = max(a0, 0), min(a1, H)
    cb0, cb1 = max(b0, 0), min(b1, W)
    if ra0 < ra1 and cb0 < cb1:
        out[ra0 - a0:ra1 - a0, cb0 - b0:cb1 - b0] = field[ra0:ra1, cb0:cb1]
    return out


def patches(um0: np.ndarray, u0: np.ndarray, corners: list[tuple[int, int]],
            size: int, steps: int, c: float, *, device="cpu",
            dtype: torch.dtype = torch.float32,
            store: torch.dtype | None = None) -> torch.Tensor:
    """The field after ``steps`` steps from ``(um0, u0)`` on the ``size x
    size`` patches whose first cells are ``corners``: ``[len(corners),
    size, size]`` in ``dtype``.  With ``store``, each step's result is
    rounded to ``store`` (the control's lower precision)."""
    H, W = u0.shape
    k = steps

    def blocks(field):
        b = np.stack([initial_block(field, r, q, size, k) for r, q in corners])
        return torch.from_numpy(b).to(device=device, dtype=dtype)[:, None]

    um, u = blocks(um0), blocks(u0)
    if store is not None:
        um, u = um.to(store).to(dtype), u.to(store).to(dtype)
    kern = torch.tensor([[0.0, c, 0.0], [c, 2.0 - 4.0 * c, c], [0.0, c, 0.0]],
                        dtype=dtype, device=device)[None, None]
    r0 = torch.tensor([r for r, _ in corners], device=device)[:, None]
    q0 = torch.tensor([q for _, q in corners], device=device)[:, None]
    for s in range(1, k + 1):
        n = size + 2 * (k - s)
        # global index of the first row/column of the block after step s
        off = torch.arange(n, device=device)[None, :] - (k - s)
        rows, cols = r0 + off, q0 + off
        rmask = ((rows > 0) & (rows < H - 1)).to(dtype)[:, None, :, None]
        cmask = ((cols > 0) & (cols < W - 1)).to(dtype)[:, None, None, :]
        un = torch.nn.functional.conv2d(u, kern)
        un.sub_(um[:, :, 1:-1, 1:-1]).mul_(rmask).mul_(cmask)
        if store is not None:
            un = un.to(store).to(dtype)
        um, u = u[:, :, 1:-1, 1:-1], un
    return u[:, 0]
