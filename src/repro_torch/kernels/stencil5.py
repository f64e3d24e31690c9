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
from contextlib import contextmanager

import torch

from . import _build

_count_lock = threading.Lock()
_hint = threading.local()


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


@contextmanager
def writing_into(dst: torch.Tensor):
    """Within this scope, on this thread, :func:`wave_step_rows` writes its
    step into ``dst`` and returns ``dst`` where ``dst`` can take it.

    A hint and not an argument: the step kernel calls ``wave_step_rows``
    with its five arguments, so that a function standing in for it (the
    benchmark's planted faults) keeps working and returns a fresh tensor,
    which the kernel stores as before.  The hint is thread-local because
    each device lane runs its kernels on a thread of its own."""
    prev = getattr(_hint, "dst", None)
    _hint.dst = dst
    try:
        yield
    finally:
        _hint.dst = prev


def _extent(t: torch.Tensor) -> tuple[int, int]:
    """The bytes ``[first, end)`` that ``t`` spans in its storage."""
    span = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (span + 1) * t.element_size()


def _destination(um_chunk: torch.Tensor,
                 u_ext: torch.Tensor) -> torch.Tensor | None:
    """The hinted destination if it is contiguous, has the chunk's shape,
    dtype and device, and shares no byte with the inputs; else None."""
    dst = getattr(_hint, "dst", None)
    if (dst is None or not dst.is_contiguous()
            or dst.shape != um_chunk.shape or dst.dtype != um_chunk.dtype
            or dst.device != um_chunk.device):
        return None
    lo, hi = _extent(dst)
    for t in (um_chunk, u_ext):
        a, b = _extent(t)
        if a < hi and lo < b:
            return None
    return dst


def _count(launches: int = 0, in_place: int = 0) -> None:
    with _count_lock:
        wave_step_rows.launches += launches
        wave_step_rows.in_place += in_place


def wave_step_rows(um_chunk: torch.Tensor, u_ext: torch.Tensor, row0: int,
                   H: int, c: float = 0.25) -> torch.Tensor:
    """Next field ``[rows, W]`` on the chunk ``[row0, row0 + rows)`` of an
    ``H``-row field, from ``um_chunk`` ``[rows, W]`` and the slab ``u_ext``.

    A CUDA tensor goes through the kernel on the current stream (float32 or
    float64, contiguous); a CPU tensor through the plain version.  Inside
    :func:`writing_into` the result is the destination, written in place,
    where it is contiguous, matches the chunk and overlaps neither input;
    otherwise a fresh tensor.  Each kernel launch adds one to
    ``wave_step_rows.launches``; each call that wrote into a destination
    (a launch on the card, a plain step on the CPU) one to
    ``wave_step_rows.in_place``.
    """
    dst = _destination(um_chunk, u_ext)
    if um_chunk.device.type == "cpu":
        out = wave_step_rows_plain(um_chunk, u_ext, row0, H, c)
        if dst is None:
            return out
        dst.copy_(out)
        _count(in_place=1)
        return dst
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
    out = torch.empty_like(um_chunk) if dst is None else dst
    if rows == 0 or W == 0:
        return out
    fn = getattr(_build.library(), fns[um_chunk.dtype])
    with torch.cuda.device(um_chunk.device):
        stream = torch.cuda.current_stream(um_chunk.device).cuda_stream
        err = fn(um_chunk.data_ptr(), u_ext.data_ptr(), out.data_ptr(), rows,
                 W, row0, H, top, ctypes.c_float(c), stream)
    _build.check(err, "wave_step_rows launch")
    _count(launches=1, in_place=int(dst is not None))
    return out


wave_step_rows.launches = 0
wave_step_rows.in_place = 0
