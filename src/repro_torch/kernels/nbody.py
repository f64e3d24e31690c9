"""Softened all-pairs gravity on a row range (kernel B1).

Replaces the Pallas TPU kernel ``src/repro/kernels/nbody.py:_kernel``
(``nbody_forces_tpu``).  The runtime's ``timestep`` needs the forces on its
chunk's rows from all bodies, so the entry point takes a row range
``[lo, hi)`` of the whole position array.

On a CUDA tensor :func:`nbody_forces_rows` launches the hand-written kernel
in ``csrc/nbody.cu`` (compute-bound, 18 f32 operations per pair; see
the source note there).  On a CPU tensor it runs the plain PyTorch version,
:func:`nbody_forces_rows_plain`, which repeats the TPU kernel's arithmetic.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# f32 operations per body pair that bound the kernel (see csrc/nbody.cu)
FLOPS_PER_PAIR = 18

# target rows per step of the plain version, to bound its [rows, N, 3]
# temporaries
_BLOCK_ROWS = 256

_count_lock = threading.Lock()


def _check_args(p_all: torch.Tensor, lo: int, hi: int) -> None:
    if p_all.dim() != 2 or p_all.shape[1] != 3:
        raise ValueError(f"p_all must be [N, 3], got {tuple(p_all.shape)}")
    if not 0 <= lo <= hi <= p_all.shape[0]:
        raise ValueError(f"row range [{lo}, {hi}) outside [0, {p_all.shape[0]})")


def nbody_forces_rows_plain(p_all: torch.Tensor, lo: int, hi: int,
                            soft: float = 1e-3) -> torch.Tensor:
    """Plain PyTorch version: forces on rows ``[lo, hi)`` from all of
    ``p_all``, in f32 with ``rsqrt`` cubed as the TPU kernel computes them,
    returned in ``p_all``'s dtype."""
    _check_args(p_all, lo, hi)
    pa = p_all.to(torch.float32)
    out = torch.empty((hi - lo, 3), dtype=torch.float32, device=p_all.device)
    for b in range(lo, hi, _BLOCK_ROWS):
        e = min(hi, b + _BLOCK_ROWS)
        d = pa[None, :, :] - pa[b:e, None, :]          # [rows, N, 3]
        r2 = (d * d).sum(-1) + soft
        inv = torch.rsqrt(r2)
        w = inv * inv * inv                            # 1 / r^3
        out[b - lo:e - lo] = (d * w[..., None]).sum(1)
    return out.to(p_all.dtype)


def nbody_forces_rows(p_all: torch.Tensor, lo: int, hi: int,
                      soft: float = 1e-3) -> torch.Tensor:
    """Forces ``[hi - lo, 3]`` on rows ``[lo, hi)`` of ``p_all`` ``[N, 3]``.

    A CUDA tensor goes through the kernel on the current stream (float32 or
    float64, contiguous); a CPU tensor through the plain version.  Each
    kernel launch adds one to ``nbody_forces_rows.launches``.
    """
    if p_all.device.type == "cpu":
        return nbody_forces_rows_plain(p_all, lo, hi, soft)
    _check_args(p_all, lo, hi)
    if not p_all.is_cuda:
        raise ValueError(f"unsupported device {p_all.device}")
    fns = {torch.float32: "repro_nbody_rows_f32",
           torch.float64: "repro_nbody_rows_f64"}
    if p_all.dtype not in fns:
        raise TypeError(f"kernel takes float32 or float64, got {p_all.dtype}")
    if not p_all.is_contiguous():
        raise ValueError("kernel takes a contiguous p_all")
    out = torch.empty((hi - lo, 3), dtype=p_all.dtype, device=p_all.device)
    if hi == lo:
        return out
    fn = getattr(_build.library(), fns[p_all.dtype])
    with torch.cuda.device(p_all.device):
        stream = torch.cuda.current_stream(p_all.device).cuda_stream
        err = fn(p_all.data_ptr(), out.data_ptr(), p_all.shape[0], lo, hi,
                 ctypes.c_float(soft), stream)
    _build.check(err, "nbody_forces_rows launch")
    with _count_lock:
        nbody_forces_rows.launches += 1
    return out


nbody_forces_rows.launches = 0
