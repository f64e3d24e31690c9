"""Mamba2's SSD chunked scan (kernel B4).

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py:_kernel``
(``ssd_scan_tpu``).  ``x`` is ``[b, s, h, p]``, ``a`` ``[b, s, h]`` the
per-step log-decay in float32, ``B`` and ``C`` ``[b, s, n]`` (one group,
shared by all heads).  Per chunk of ``chunk`` steps, with ``cs`` the
cumulative sum of ``a`` inside the chunk::

    y     = ((C B^T) * L) x + diag(exp(cs)) C h_prev,  L[i, j] = exp(cs_i - cs_j), j <= i
    h_new = exp(cs_end) h_prev + sum_j exp(cs_end - cs_j) x_j B_j^T

chunks in order from ``h = 0``.  Returns ``y`` in ``x``'s dtype and the state
after the last step, ``[b, h, p, n]`` in float32.  A ragged ``s`` is padded
with ``x = 0``, ``a = 0`` steps, which leave the state as it is.

On a CUDA tensor :func:`ssd_scan` launches the hand-written kernel in
``csrc/ssd_scan.cu``; on a CPU tensor it runs the plain PyTorch version,
:func:`ssd_scan_plain`, the twin of ``repro.models.mamba2.ssd_chunked``.
Under autograd the forward is the same, and the backward is autograd of the
plain version recomputed from the inputs (:class:`_SSDScan`), but for its
recurrence over chunks, :func:`ssd_state_pass`: on the card one hand-written
launch forward and one backward (``csrc/ssd_state_pass.cu``), elsewhere
:func:`ssd_state_pass_plain`, which :func:`ssd_scan_plain` runs on every
device.
:func:`ssd_chunk_ref` is the twin of ``repro.kernels.ref.ssd_chunk_ref``.

A launch on plain CUDA tensors calls the kernel directly; on fake tensors,
DTensors or under a dispatch mode that watches the ops it goes through the
custom op ``repro_torch::ssd_scan_fwd`` (the same launch): its fake
implementation allocates ``y`` and ``state`` without building or loading
the kernel, its flop formula is ``FlopCounterMode``'s count of the plain
version at the same shapes, and its DTensor sharding rule splits the batch
or the heads, so a dry-run (``launch/dryrun.py``) traces it without
launching (the models' Mamba2 layers reach it on each card's shard of
batch and heads, ``Mamba2LM._per_shard``).
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from . import _build

MAX_CHUNK = 64
MAX_STATE = 128

_count_lock = threading.Lock()


def segsum(a: torch.Tensor) -> torch.Tensor:
    """log-space segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k];
    ``-inf`` above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def _check_args(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4 or a.dim() != 3 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"want x [b,s,h,p], a [b,s,h] and B, C [b,s,n]; got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if tuple(a.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"a {tuple(a.shape)} or B {tuple(B.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if s == 0:
        raise ValueError("empty sequence")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: int):
    """Plain PyTorch version, the twin of ``ssd_chunked``: products and the
    carried state in f32; ``h_prev`` rounded to ``x``'s dtype before the
    ``C h_prev`` term, as ``ssd_chunked`` rounds it.  Its recurrence over
    chunks is :func:`ssd_state_pass_plain` on every device."""
    return _ssd_scan_body(x, a, B, C, chunk, ssd_state_pass_plain)


def _ssd_scan_body(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: int, state_pass):
    """:func:`ssd_scan_plain` with ``state_pass(states, chunk_decay) ->
    (hprev, hlast)`` as its recurrence over chunks."""
    _check_args(x, a, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = -s % chunk
    if pad:
        # x = 0, a = 0 (decay 1) steps are identities
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c = (s + pad) // chunk
    xc = x.reshape(b, c, chunk, h, p).float()
    ac = a.reshape(b, c, chunk, h).permute(0, 1, 3, 2).float()   # [b,c,h,q]
    Bc = B.reshape(b, c, chunk, n).float()
    Cc = C.reshape(b, c, chunk, n).float()

    # 1. intra-chunk: causal-decay-masked "attention"
    Lmat = torch.exp(segsum(ac))                                  # [b,c,h,q,q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, :, None] * Lmat
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # 2. chunk states: decay-weighted sum of x B^T within each chunk
    a_cum = torch.cumsum(ac, dim=-1)                              # [b,c,h,q]
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_to_end, Bc, xc)

    # 3. inter-chunk recurrence over c, in f32
    chunk_decay = torch.exp(a_cum[..., -1])                       # [b,c,h]
    hprev, hlast = state_pass(states, chunk_decay)
    hprev = hprev.to(x.dtype).float()                             # [b,c,h,p,n]

    # 4. inter-chunk output: C_t (decay from chunk start) h_prev
    y_inter = torch.einsum("bcqn,bchq,bchpn->bcqhp", Cc, torch.exp(a_cum),
                           hprev)
    y = (y_intra + y_inter).to(x.dtype).reshape(b, c * chunk, h, p)
    return y[:, :s], hlast


def ssd_state_pass_plain(states: torch.Tensor, chunk_decay: torch.Tensor):
    """Step 3 of :func:`ssd_scan_plain`, the recurrence over chunks in f32:
    ``states [b,c,h,p,n]`` and ``chunk_decay [b,c,h]`` give ``hprev
    [b,c,h,p,n]`` (the state before each chunk, 0 before the first) and
    ``hlast [b,h,p,n]``, with ``h_{ci+1} = chunk_decay_ci * h_ci +
    states_ci``.  Both inputs are unbound once, so the backward adds each
    chunk's gradient into its own slice and not into a zero tensor of all
    the states."""
    b, _, h, p, n = states.shape
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32,
                       device=states.device)
    hprevs = []
    for st, dec in zip(states.unbind(1), chunk_decay.unbind(1)):
        hprevs.append(hcur)
        hcur = dec[:, :, None, None] * hcur + st
    return torch.stack(hprevs, dim=1), hcur


def ssd_chunk_ref(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor):
    """Single-chunk SSD, the oracle of the chunk body: ``x [q,h,p]``,
    ``a [q,h]``, ``B, C [q,n]`` (no batch).  Returns the intra-chunk output
    ``[q,h,p]`` and the end-of-chunk state ``[h,p,n]``."""
    q = x.shape[0]
    cs = torch.cumsum(a, dim=0)                                   # [q,h]
    seg = cs[:, None, :] - cs[None, :, :]                         # [i,j,h]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask[..., None], torch.exp(seg), 0.0)
    scores = torch.einsum("in,jn,ijh->hij", C, B, Lmat)
    y = torch.einsum("hij,jhp->ihp", scores, x)
    decay_end = torch.exp(cs[-1][None, :] - cs)                   # [q,h]
    state = torch.einsum("qh,qn,qhp->hpn", decay_end, B, x)
    return y, state


def _launch(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, chunk: int):
    """Kernel B4 on the current stream: ``(y, state)``; through the custom
    op ``repro_torch::ssd_scan_fwd`` unless ``_build.direct``.  On fake
    tensors (a dry-run's trace) the op only allocates its outputs."""
    _check_args(x, a, B, C, chunk)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _FNS:
        raise TypeError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B and C must have x's dtype {x.dtype}, got "
                        f"{B.dtype}, {C.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"kernel takes a float32 a, got {a.dtype}")
    if any(t.device != x.device for t in (a, B, C)):
        raise ValueError("x, a, B and C must be on one device")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"kernel takes chunk up to {MAX_CHUNK} and n up to "
                         f"{MAX_STATE}, got {chunk} and {n}")
    if h > 65535 or b > 65535:
        raise ValueError(f"h = {h} or b = {b} exceeds the grid's 65535")
    for name, t in (("x", x), ("a", a), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"kernel takes a contiguous {name}")
    if _build.direct(x, a, B, C):
        return _ssd_scan_fwd_kernel(x, a, B, C, chunk)
    return torch.ops.repro_torch.ssd_scan_fwd(x, a, B, C, chunk)


_FNS = {torch.float32: "repro_ssd_scan_f32",
        torch.bfloat16: "repro_ssd_scan_bf16"}


def _ssd_scan_fwd_kernel(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, chunk: int):
    """The launch of kernel B4.  Adds one to ``ssd_scan.launches``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library(), _FNS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                 y.data_ptr(), state.data_ptr(), b, s, h, p, n, chunk, stream)
    _build.check(err, "ssd_scan launch")
    with _count_lock:
        ssd_scan.launches += 1
    return y, state


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=(),
                         device_types="cuda")
def _ssd_scan_fwd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    return _ssd_scan_fwd_kernel(x, a, B, C, chunk)


@_ssd_scan_fwd.register_fake
def _(x, a, B, C, chunk):
    b, s, h, p = x.shape
    return (torch.empty_like(x),
            x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _plain_flops(x_shape, B_shape, chunk) -> int:
    with _disable_current_modes(), FlopCounterMode(display=False) as fc:
        b, s, h, _ = x_shape
        ssd_scan_plain(torch.empty(x_shape, device="meta"),
                       torch.empty((b, s, h), device="meta"),
                       torch.empty(B_shape, device="meta"),
                       torch.empty(B_shape, device="meta"), chunk)
    return fc.get_total_flops()


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _ssd_flops(x_shape, a_shape, B_shape, C_shape, chunk, *args,
               out_shape=None, **kwargs) -> int:
    """What ``FlopCounterMode`` counts of :func:`ssd_scan_plain` at the same
    shapes (counted once per shape on meta tensors, outside any mode)."""
    return _plain_flops(tuple(x_shape), tuple(B_shape), chunk)


@register_sharding(torch.ops.repro_torch.ssd_scan_fwd.default)
def _ssd_sharding(x, a, B, C, chunk):
    """Per mesh dim: replicated, batch-sharded, or head-sharded (``B`` and
    ``C`` are shared by all heads, so heads do not split them)."""
    R = Replicate()
    return [([R, R], [R, R, R, R, None]),
            ([Shard(0), Shard(0)], [Shard(0)] * 4 + [None]),
            ([Shard(2), Shard(1)], [Shard(2), Shard(2), R, R, None])]


def _check_state_pass(states: torch.Tensor, chunk_decay: torch.Tensor) -> None:
    if states.dim() != 5 or tuple(chunk_decay.shape) != tuple(states.shape[:3]):
        raise ValueError(f"want states [b,c,h,p,n] and chunk_decay [b,c,h]; "
                         f"got {tuple(states.shape)}, "
                         f"{tuple(chunk_decay.shape)}")
    if states.dtype != torch.float32 or chunk_decay.dtype != torch.float32:
        raise TypeError(f"the recurrence takes float32, got {states.dtype}, "
                        f"{chunk_decay.dtype}")
    if chunk_decay.device != states.device:
        raise ValueError("states and chunk_decay must be on one device")
    if states.numel() == 0:
        raise ValueError(f"empty states {tuple(states.shape)}")
    b, _, h, p, n = states.shape
    if h > 65535 or b > 65535 or p * n >= 2**31:
        raise ValueError(f"b = {b}, h = {h} or p * n = {p * n} exceeds the "
                         f"kernels' grid")


def _count_state_pass() -> None:
    with _count_lock:
        ssd_state_pass.launches += 1


def _state_pass_fwd_kernel(states: torch.Tensor, chunk_decay: torch.Tensor):
    """The forward launch: ``(hprev, hlast)``.  Adds one to
    ``ssd_state_pass.launches``."""
    b, c, h, p, n = states.shape
    hprev = torch.empty(states.shape, dtype=torch.float32,
                        device=states.device)
    hlast = torch.empty((b, h, p, n), dtype=torch.float32,
                        device=states.device)
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = _build.library().repro_ssd_state_pass_fwd(
            states.data_ptr(), chunk_decay.data_ptr(), hprev.data_ptr(),
            hlast.data_ptr(), b, c, h, p * n, stream)
    _build.check(err, "ssd_state_pass forward launch")
    _count_state_pass()
    return hprev, hlast


def _state_pass_bwd_kernel(chunk_decay: torch.Tensor, hprev: torch.Tensor,
                           dhprev: Optional[torch.Tensor],
                           dhlast: Optional[torch.Tensor]):
    """The reverse launch: ``(dstates, ddecay)``; a missing ``dhprev`` or
    ``dhlast`` reads as zeros.  Adds one to ``ssd_state_pass.launches``."""
    b, c, h, p, n = hprev.shape
    dstates = torch.empty(hprev.shape, dtype=torch.float32,
                          device=hprev.device)
    ddecay = torch.empty(chunk_decay.shape, dtype=torch.float32,
                         device=hprev.device)
    ptr = [None if t is None else t.data_ptr() for t in (dhprev, dhlast)]
    with torch.cuda.device(hprev.device):
        stream = torch.cuda.current_stream(hprev.device).cuda_stream
        err = _build.library().repro_ssd_state_pass_bwd(
            chunk_decay.data_ptr(), hprev.data_ptr(), *ptr,
            dstates.data_ptr(), ddecay.data_ptr(), b, c, h, p * n, stream)
    _build.check(err, "ssd_state_pass backward launch")
    _count_state_pass()
    return dstates, ddecay


@torch.library.custom_op("repro_torch::ssd_state_pass_fwd", mutates_args=(),
                         device_types="cuda")
def _ssd_state_pass_fwd(states: torch.Tensor, chunk_decay: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    return _state_pass_fwd_kernel(states, chunk_decay)


@_ssd_state_pass_fwd.register_fake
def _(states, chunk_decay):
    b, _, h, p, n = states.shape
    return torch.empty_like(states), states.new_empty((b, h, p, n))


@torch.library.custom_op("repro_torch::ssd_state_pass_bwd", mutates_args=(),
                         device_types="cuda")
def _ssd_state_pass_bwd(chunk_decay: torch.Tensor, hprev: torch.Tensor,
                        dhprev: Optional[torch.Tensor],
                        dhlast: Optional[torch.Tensor]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    return _state_pass_bwd_kernel(chunk_decay, hprev, dhprev, dhlast)


@_ssd_state_pass_bwd.register_fake
def _(chunk_decay, hprev, dhprev, dhlast):
    return torch.empty_like(hprev), torch.empty_like(chunk_decay)


@register_sharding(torch.ops.repro_torch.ssd_state_pass_fwd.default)
def _state_pass_fwd_sharding(states, chunk_decay):
    """Per mesh dim: replicated, batch-sharded, or head-sharded (``hlast``'s
    heads are its dim 1)."""
    R = Replicate()
    return [([R, R], [R, R]),
            ([Shard(0), Shard(0)], [Shard(0), Shard(0)]),
            ([Shard(2), Shard(1)], [Shard(2), Shard(2)])]


@register_sharding(torch.ops.repro_torch.ssd_state_pass_bwd.default)
def _state_pass_bwd_sharding(chunk_decay, hprev, dhprev, dhlast):
    """The forward's rule, read backwards; a missing gradient has no
    placement."""
    R = Replicate()

    def of(p, last):
        return [p, p, None if dhprev is None else p,
                None if dhlast is None else last]
    return [([R, R], of(R, R)),
            ([Shard(0), Shard(0)], of(Shard(0), Shard(0))),
            ([Shard(2), Shard(2)], of(Shard(2), Shard(1)))]


class _StatePass(torch.autograd.Function):
    """The recurrence on the card: one forward launch, one reverse launch.
    ``hprev`` is saved for the reverse (the plain loop's autograd saves the
    same states, one chunk at a time)."""

    @staticmethod
    def forward(ctx, states, chunk_decay):
        if _build.direct(states, chunk_decay):
            hprev, hlast = _state_pass_fwd_kernel(states, chunk_decay)
        else:
            hprev, hlast = torch.ops.repro_torch.ssd_state_pass_fwd(
                states, chunk_decay)
        ctx.save_for_backward(chunk_decay, hprev)
        ctx.set_materialize_grads(False)
        return hprev, hlast

    @staticmethod
    def backward(ctx, dhprev, dhlast):
        if dhprev is None and dhlast is None:
            return None, None
        chunk_decay, hprev = ctx.saved_tensors
        grads = [None if g is None else g.contiguous()
                 for g in (dhprev, dhlast)]
        if _build.direct(chunk_decay, hprev,
                         *(g for g in grads if g is not None)):
            return _state_pass_bwd_kernel(chunk_decay, hprev, *grads)
        return torch.ops.repro_torch.ssd_state_pass_bwd(chunk_decay, hprev,
                                                        *grads)


def ssd_state_pass(states: torch.Tensor, chunk_decay: torch.Tensor):
    """Step 3 of :func:`ssd_scan_plain`: ``(hprev [b,c,h,p,n], hlast
    [b,h,p,n])`` from ``states [b,c,h,p,n]`` and ``chunk_decay [b,c,h]``,
    all float32.

    A CUDA tensor goes through the hand-written kernels in
    ``csrc/ssd_state_pass.cu`` (:class:`_StatePass`): one launch forward,
    one in the backward, each adding one to ``ssd_state_pass.launches``;
    ``hprev``, ``hlast`` and the states' gradient equal
    :func:`ssd_state_pass_plain`'s bit for bit, and the decays' gradient
    differs only by the order of its sum over ``p, n``.  On plain CUDA
    tensors the kernels are called directly; on fake tensors, DTensors or
    under a dispatch mode they go through the custom ops
    ``repro_torch::ssd_state_pass_fwd`` and ``_bwd``.  Any other tensor
    goes through :func:`ssd_state_pass_plain`."""
    if states.device.type != "cuda":
        return ssd_state_pass_plain(states, chunk_decay)
    _check_state_pass(states, chunk_decay)
    return _StatePass.apply(states.contiguous(), chunk_decay.contiguous())


ssd_state_pass.launches = 0


class _SSDScan(torch.autograd.Function):
    """B4 (its plain version on the CPU) forward; the backward is autograd
    of :func:`ssd_scan_plain` recomputed from the saved inputs, with
    :func:`ssd_state_pass` as its recurrence over chunks (the JAX model's
    gradient is ``jax.grad`` through the jnp ``ssd_chunked``; no Pallas
    backward exists).  An output the loss does not use (the final
    state, in training) brings no gradient and is left out of it."""

    @staticmethod
    def forward(ctx, x, a, B, C, chunk):
        if x.device.type == "cpu":
            y, state = ssd_scan_plain(x, a, B, C, chunk)
        else:
            y, state = _launch(x, a, B, C, chunk)
        ctx.save_for_backward(x, a, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = _ssd_scan_body(*inputs, ctx.chunk, ssd_state_pass)
        outs = [(o, g) for o, g in ((y, dy), (state, dstate))
                if g is not None]
        if not outs:
            return None, None, None, None, None
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in outs],
                                         wanted, [g for _, g in outs],
                                         allow_unused=True))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int = 64):
    """SSD over whole sequences: ``(y [b,s,h,p], state [b,h,p,n] f32)``.

    A CUDA tensor goes through the kernel on the current stream: ``x``, ``B``
    and ``C`` float32 or bfloat16 (one dtype), ``a`` float32, all contiguous,
    ``chunk`` up to 64 and ``n`` up to 128; any ``s``.  The kernel keeps the
    products and the carried state in f32 and rounds ``h_prev`` to ``x``'s
    dtype before the ``C h_prev`` term, as ``ssd_chunked`` (the function the
    JAX model runs) does; the TPU kernel keeps it in f32.  In bfloat16 the
    products run on the tensor cores, each f32 operand split into bf16
    terms (two for the scores, three for the state update), so the state
    keeps the f32 tolerance.  Against
    :func:`ssd_scan_plain` on the same inputs: 2e-4 in f32 (sums in another
    order, ``tests/test_kernels.py``'s tolerance); in bf16, one bf16 step of
    ``y`` (both round the same f32 value of ``y`` once, and the f32 values
    differ by sums taken in another order, which can cross a rounding
    boundary; ``h_prev`` rounds alike unless the same happens to it).

    A CPU tensor goes through the plain version.  Where autograd records
    and an input requires grad, the call runs under :class:`_SSDScan`,
    whose backward is plain PyTorch but for its recurrence over chunks
    (:func:`ssd_state_pass`).  Each kernel launch adds one to
    ``ssd_scan.launches``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, B, C)):
        return _SSDScan.apply(x, a, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, B, C, chunk)
    return _launch(x, a, B, C, chunk)


ssd_scan.launches = 0
