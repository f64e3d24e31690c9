"""One 5-point wave step on a chunk of rows (kernel B2).

Replaces the Pallas TPU kernel ``src/repro/kernels/stencil5.py:_kernel``
(``wave_step_tpu``).  The TPU kernel took pre-shifted copies of ``u``; here
the caller hands over the runtime's ``neighborhood((1, 0))`` slab ``u_ext``
(the chunk's rows plus one halo row on each side that exists) and the
chunk's global first row ``row0``, so that rows 0 and ``H - 1`` stay zero.

On a CUDA tensor :func:`wave_step_rows` launches the hand-written kernel in
``csrc/stencil5.cu`` (memory-bound: read ``um`` and ``u``, write ``un``; see
the source note there).  On a CPU tensor it runs the plain PyTorch version,
:func:`wave_step_rows_plain`, which repeats the TPU kernel's arithmetic.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

_count_lock = threading.Lock()


def halo_rows(row0: int, rows: int, H: int) -> tuple[int, int]:
    """Halo rows above and below a chunk ``[row0, row0 + rows)`` of ``H``."""
    return int(row0 > 0), int(row0 + rows < H)


def _check_args(um_chunk: torch.Tensor, u_ext: torch.Tensor, row0: int,
                H: int) -> tuple[int, int]:
    """Validate the shapes; return the halo rows above and below the chunk."""
    if um_chunk.dim() != 2 or u_ext.dim() != 2:
        raise ValueError("um_chunk and u_ext must be 2-D")
    rows, W = um_chunk.shape
    if not 0 <= row0 <= H - rows:
        raise ValueError(f"chunk [{row0}, {row0 + rows}) outside [0, {H})")
    top, bottom = halo_rows(row0, rows, H)
    if tuple(u_ext.shape) != (rows + top + bottom, W):
        raise ValueError(
            f"u_ext must be [{rows + top + bottom}, {W}] (chunk rows plus "
            f"halo), got {tuple(u_ext.shape)}")
    if um_chunk.dtype != u_ext.dtype or um_chunk.device != u_ext.device:
        raise ValueError("um_chunk and u_ext differ in dtype or device")
    return top, bottom


def wave_step_rows_plain(um_chunk: torch.Tensor, u_ext: torch.Tensor,
                         row0: int, H: int, c: float = 0.25) -> torch.Tensor:
    """Plain PyTorch version: the shifted-sum Laplacian in f32, zero on the
    Dirichlet border, returned in the input dtype."""
    top, bottom = _check_args(um_chunk, u_ext, row0, H)
    rows, W = um_chunk.shape
    um = um_chunk.to(torch.float32)
    # a zero row stands in for a missing halo; it only feeds border rows
    ext = torch.nn.functional.pad(u_ext.to(torch.float32),
                                  (0, 0, 1 - top, 1 - bottom))
    mid = ext[1:rows + 1]
    up, dn = ext[0:rows], ext[2:rows + 2]
    left = torch.roll(mid, 1, dims=1)
    right = torch.roll(mid, -1, dims=1)
    lap = up + dn + left + right - 4.0 * mid
    un = 2.0 * mid - um + c * lap
    row = row0 + torch.arange(rows, device=um.device)[:, None]
    col = torch.arange(W, device=um.device)[None, :]
    interior = (row > 0) & (row < H - 1) & (col > 0) & (col < W - 1)
    return torch.where(interior, un, 0.0).to(um_chunk.dtype)


def wave_step_rows(um_chunk: torch.Tensor, u_ext: torch.Tensor, row0: int,
                   H: int, c: float = 0.25) -> torch.Tensor:
    """Next field ``[rows, W]`` on the chunk ``[row0, row0 + rows)`` of an
    ``H``-row field, from ``um_chunk`` ``[rows, W]`` and the slab ``u_ext``.

    A CUDA tensor goes through the kernel on the current stream (float32 or
    float64, contiguous); a CPU tensor through the plain version.  Each
    kernel launch adds one to ``wave_step_rows.launches``.
    """
    if um_chunk.device.type == "cpu":
        return wave_step_rows_plain(um_chunk, u_ext, row0, H, c)
    top, _ = _check_args(um_chunk, u_ext, row0, H)
    if not um_chunk.is_cuda:
        raise ValueError(f"unsupported device {um_chunk.device}")
    fns = {torch.float32: "repro_wave_rows_f32",
           torch.float64: "repro_wave_rows_f64"}
    if um_chunk.dtype not in fns:
        raise TypeError(f"kernel takes float32 or float64, got {um_chunk.dtype}")
    if not (um_chunk.is_contiguous() and u_ext.is_contiguous()):
        raise ValueError("kernel takes contiguous um_chunk and u_ext")
    rows, W = um_chunk.shape
    out = torch.empty_like(um_chunk)
    if rows == 0 or W == 0:
        return out
    fn = getattr(_build.library(), fns[um_chunk.dtype])
    with torch.cuda.device(um_chunk.device):
        stream = torch.cuda.current_stream(um_chunk.device).cuda_stream
        err = fn(um_chunk.data_ptr(), u_ext.data_ptr(), out.data_ptr(), rows,
                 W, row0, H, top, ctypes.c_float(c), stream)
    _build.check(err, "wave_step_rows launch")
    with _count_lock:
        wave_step_rows.launches += 1
    return out


wave_step_rows.launches = 0
