"""Flash attention forward for grouped queries (kernel B3).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:_kernel``
(``flash_attention_tpu``).  ``q`` is ``[B, S, K, G, hd]`` (``G`` query heads
per KV head) and ``k``/``v`` are ``[B, T, K, hd]``; the result has ``q``'s
shape and dtype.  Scale ``scale`` (``1/sqrt(hd)`` unless given), causal and
sliding-window masks with ``-1e30``, an online softmax with ``m``, ``l`` and the accumulator in f32,
and the decode ``q_offset`` (query ``i`` sits at position ``i + q_offset``).

With ``return_lse`` the wrapper also gives each query row's logsumexp,
``lse = m + log(l)``, f32 ``[B, K, G, S]``, which the kernel writes from its
epilogue.  Where an input requires grad, :func:`flash_attention` runs as a
``torch.autograd.Function`` that keeps ``q, k, v, out, lse`` and whose
backward, :func:`flash_attention_backward`, is the plain PyTorch twin of the
reference's blockwise backward (``repro.kernels.ref._flash_bwd``, jnp and
not Pallas): probabilities recomputed per block from ``lse``.

On a CUDA tensor :func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attention.cu`` (contiguous, 16-byte aligned, ``hd`` a multiple
of 8 up to 128): in bfloat16 with TMA loads and ``wgmma`` tensor-core
products, the softmax weights rounded to bf16 before the product with ``v``
as the JAX reference rounds them; in float32 with f32 products on the CUDA
cores.  On a CPU tensor it runs the plain PyTorch version,
:func:`flash_attention_plain`, the twin of the JAX package's blockwise
reference (``repro.kernels.ref._flash_fwd_impl``).

A launch on plain CUDA tensors calls the kernel directly; on fake tensors,
DTensors or under a dispatch mode that watches the ops it goes through the
custom op ``repro_torch::flash_attention_fwd`` (whose real implementation is
the same launch).  Its fake
implementation allocates ``out`` and ``lse`` without building or loading
the kernel, its flop formula counts ``4 B H hd`` per unmasked (query, key)
pair, and its DTensor sharding rule splits the batch or the KV heads, so a
dry-run (``launch/dryrun.py``) traces it over fake CUDA tensors on a mesh
and launches nothing.  DTensors on the CPU run the plain version per shard
(``local_map``), and so does the plain backward of a DTensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128

# block sizes of the JAX reference (ref.flash_attention_ref's defaults)
_Q_BLOCK, _KV_BLOCK = 512, 1024

# the f32 kernel's grid is (row blocks, B * K); the bf16 kernel's is one
# dimension of B * K times its row blocks of 128
_BF16_ROWS = 128
_MAX_GRID_Y, _MAX_GRID_X = 65535, 2**31 - 1

_count_lock = threading.Lock()


def default_scale(hd: int, scale: Optional[float] = None) -> float:
    """``scale``, or ``1/sqrt(hd)`` where it is None."""
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: Optional[int], q_offset: int) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,S,K,G,hd] and k, v [B,T,K,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, K, G, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, K, hd):
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if S == 0 or k.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def _block_mask(q0: int, k0: int, nq: int, nk: int, T: int, causal: bool,
                window: Optional[int], device) -> torch.Tensor:
    qpos = q0 + torch.arange(nq, device=device)[:, None]
    kpos = k0 + torch.arange(nk, device=device)[None, :]
    mask = (kpos < T).expand(nq, nk)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0, return_lse: bool = False,
                          scale: Optional[float] = None):
    """Plain PyTorch version: the JAX reference's blockwise online softmax
    (query blocks of 512, key blocks of 1024), logits in f32 from exact
    f32 products, probabilities rounded to ``v``'s dtype before the second
    product, as ``ref._flash_fwd_impl`` does.  With ``return_lse`` it
    returns ``(out, lse)``."""
    _check_args(q, k, v, window, q_offset)
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = default_scale(hd, scale)
    qf, kf = q.float(), k.float()
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), device=q.device)
    for s0 in range(0, S, _Q_BLOCK):
        qblk = qf[:, s0:s0 + _Q_BLOCK]                       # [B,q,K,G,hd]
        nq = qblk.shape[1]
        m = torch.full((B, K, G, nq), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, nq), device=q.device)
        acc = torch.zeros((B, K, G, nq, hd), device=q.device)
        for t0 in range(0, T, _KV_BLOCK):
            kblk = kf[:, t0:t0 + _KV_BLOCK]
            vblk = v[:, t0:t0 + _KV_BLOCK]
            logits = torch.einsum("bqkgh,btkh->bkgqt", qblk, kblk) * scale
            mask = _block_mask(s0 + q_offset, t0, nq, kblk.shape[1], T,
                               causal, window, q.device)
            logits = torch.where(mask, logits, NEG_INF)
            m2 = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p.to(v.dtype).float(), vblk.float())
            m = m2
        l = torch.clamp_min(l, 1e-30)
        out[:, s0:s0 + nq] = (acc / l[..., None]).permute(0, 3, 1, 2, 4).to(
            q.dtype)
        lse[..., s0:s0 + nq] = m + torch.log(l)
    return (out, lse) if return_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0,
                             scale: Optional[float] = None):
    """Gradients ``(dq, dk, dv)`` of attention from the forward's ``out`` and
    ``lse``: the FA2 backward of ``ref._flash_bwd`` in plain PyTorch, over
    the same blocks (key blocks of 1024 outer, query blocks of 512 inner),
    with each block's probabilities recomputed from ``lse``.  Products run
    in f32 and the sums stay in f32 until the end; blocks that the mask
    empties are skipped (they add zeros in the reference)."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = default_scale(hd, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    # D_i = rowsum(dout * out)  [B,K,G,S]
    D = torch.einsum("bskgh,bskgh->bkgs", out.float(), dof)
    dq = torch.zeros(qf.shape, device=q.device)
    dk = torch.zeros(kf.shape, device=q.device)
    dv = torch.zeros(vf.shape, device=q.device)
    for t0 in range(0, T, _KV_BLOCK):
        kblk, vblk = kf[:, t0:t0 + _KV_BLOCK], vf[:, t0:t0 + _KV_BLOCK]
        nt = kblk.shape[1]
        for s0 in range(0, S, _Q_BLOCK):
            nq = min(_Q_BLOCK, S - s0)
            q0 = s0 + q_offset
            if causal and t0 > q0 + nq - 1:
                continue                       # wholly above the diagonal
            if window is not None and t0 + nt - 1 <= q0 - window:
                continue                       # wholly left of the window
            qblk, doblk = qf[:, s0:s0 + nq], dof[:, s0:s0 + nq]
            logits = torch.einsum("bqkgh,btkh->bkgqt", qblk, kblk) * scale
            mask = _block_mask(q0, t0, nq, nt, T, causal, window, q.device)
            p = torch.where(mask, torch.exp(logits - lse[..., s0:s0 + nq, None]),
                            0.0)
            dp = torch.einsum("bqkgh,btkh->bkgqt", doblk, vblk)
            ds = p * (dp - D[..., s0:s0 + nq, None]) * scale
            dq[:, s0:s0 + nq] += torch.einsum("bkgqt,btkh->bqkgh", ds, kblk)
            dk[:, t0:t0 + nt] += torch.einsum("bkgqt,bqkgh->btkh", ds, qblk)
            dv[:, t0:t0 + nt] += torch.einsum("bkgqt,bqkgh->btkh", p, doblk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], q_offset: int, want_lse: bool,
            scale: Optional[float] = None):
    """Kernel B3 on the current stream: ``(out, lse)``, ``lse`` None unless
    ``want_lse``; through the custom op ``repro_torch::flash_attention_fwd``
    unless ``_build.direct``.  On fake tensors (a dry-run's trace) the op
    only allocates its outputs."""
    _check_args(q, k, v, window, q_offset)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _FNS:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    B, S, K, G, hd = q.shape
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if q.dtype == torch.float32:
        if B * K > _MAX_GRID_Y:
            raise ValueError(f"B * K = {B * K} exceeds the grid's "
                             f"{_MAX_GRID_Y} rows")
    elif -(-S * G // _BF16_ROWS) * B * K > _MAX_GRID_X:
        raise ValueError(f"{B} x {S} x {K} x {G} query rows exceed the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"kernel takes a contiguous {name}")
    launch = (_flash_attention_fwd_kernel if _build.direct(q, k, v)
              else torch.ops.repro_torch.flash_attention_fwd)
    out, lse = launch(q, k, v, causal, window or 0, q_offset, want_lse,
                      scale)
    return out, (lse if want_lse else None)


_FNS = {torch.float32: "repro_flash_fwd_f32",
        torch.bfloat16: "repro_flash_fwd_bf16"}


def _lse_shape(q_shape, want_lse: bool) -> tuple:
    B, S, K, G, _ = q_shape
    return (B, K, G, S) if want_lse else (0,)


def _flash_attention_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool, window: int,
                                q_offset: int, want_lse: bool,
                                scale: Optional[float] = None):
    """The launch of kernel B3 (``window`` 0 for none; ``lse`` empty unless
    ``want_lse``).  Adds one to ``flash_attention.launches``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"kernel takes a 16-byte aligned {name}")
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(_lse_shape(q.shape, want_lse), device=q.device,
                      dtype=torch.float32)
    fn = getattr(_build.library(), _FNS[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if want_lse else None,
                 B, S, T, K, G, hd, ctypes.c_float(default_scale(hd, scale)),
                 int(causal), window, q_offset, stream)
    _build.check(err, "flash_attention launch")
    with _count_lock:
        flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, q_offset: int,
                         want_lse: bool, scale: Optional[float] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    return _flash_attention_fwd_kernel(q, k, v, causal, window, q_offset,
                                       want_lse, scale)


@_flash_attention_fwd.register_fake
def _(q, k, v, causal, window, q_offset, want_lse, scale=None):
    return (torch.empty_like(q),
            q.new_empty(_lse_shape(q.shape, want_lse), dtype=torch.float32))


def _lse_placements(pl) -> list:
    """``q``'s placements (``[B,S,K,G,hd]``) as ``lse``'s (``[B,K,G,S]``)."""
    return [Shard(1) if p.is_shard(2) else p for p in pl]


def unmasked_pairs(S: int, T: int, causal: bool, window: int,
                   q_offset: int) -> int:
    """The (query, key) pairs the masks keep: key ``j < T`` with
    ``j <= i + q_offset`` (causal) and ``j > i + q_offset - window``
    (``window`` > 0)."""
    pos = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(pos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset,
                 want_lse, *args, out_shape=None, **kwargs) -> int:
    """``4 B H hd`` per unmasked pair (``Q K^T`` and ``P V``), as PERF.md's
    bound counts B3's work, whatever the scale."""
    B, S, K, G, hd = q_shape
    return 4 * B * K * G * hd * unmasked_pairs(S, k_shape[1], causal, window,
                                               q_offset)


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _flash_sharding(q, k, v, causal, window, q_offset, want_lse,
                    scale=None):
    """Per mesh dim: replicated, batch-sharded, or KV-head-sharded where
    every mesh dim divides the KV heads (``out`` as ``q``; ``lse``
    ``[B,K,G,S]``)."""
    R = Replicate()
    rest = [None] * 5
    out = [([R, R], [R, R, R] + rest),
           ([Shard(0), Shard(0)], [Shard(0)] * 3 + rest)]
    if all(q.shape[2] % n == 0 for n in q.mesh.shape):
        out.append(([Shard(2), Shard(1)], [Shard(2)] * 3 + rest))
    return out


class _FlashAttention(torch.autograd.Function):
    """B3 (its plain version on the CPU) forward with ``lse``; the plain
    blockwise backward.  ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, q_offset=q_offset,
                                             return_lse=True, scale=scale)
        else:
            out, lse = _launch(q, k, v, causal, window, q_offset, True, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.mask
        bwd = functools.partial(flash_attention_backward, causal=causal,
                                window=window, q_offset=q_offset, scale=scale)
        if isinstance(q, DTensor):
            # per shard of batch and KV heads (a dry-run's trace)
            pl = list(q.placements)
            bwd = local_map(bwd, out_placements=(pl, pl, pl),
                            in_placements=(pl, pl, pl, pl, _lse_placements(pl),
                                           pl),
                            redistribute_inputs=True)
        dq, dk, dv = bwd(q, k, v, out, lse, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False,
                    scale: Optional[float] = None):
    """Attention of ``q`` ``[B,S,K,G,hd]`` over ``k``, ``v`` ``[B,T,K,hd]``;
    ``(out, lse)`` with ``return_lse``.  The logits are scaled by ``scale``,
    ``1/sqrt(hd)`` when it is None.

    CUDA tensors go through the kernel on the current stream; CPU tensors
    through the plain version.  Where autograd records and an input
    requires grad, the call runs under :class:`_FlashAttention`, so the
    forward keeps ``lse`` for the plain backward; otherwise the kernel runs
    without it unless asked.  Each kernel launch adds one to
    ``flash_attention.launches``.
    """
    if isinstance(q, DTensor) and q.device.type == "cpu":
        # the plain version per shard of batch and KV heads (a dry-run's
        # trace on the CPU; on the card the custom op's sharding rule
        # places the kernel)
        pl = list(q.placements)
        return local_map(
            functools.partial(flash_attention, causal=causal, window=window,
                              q_offset=q_offset, return_lse=return_lse,
                              scale=scale),
            out_placements=(pl, _lse_placements(pl)) if return_lse else pl,
            in_placements=(pl, pl, pl), redistribute_inputs=True)(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                         scale)
    elif q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=return_lse,
                                     scale=scale)
    else:
        out, lse = _launch(q, k, v, causal, window, q_offset, return_lse,
                           scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
