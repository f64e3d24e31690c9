"""Core layers of the models: norms, RoPE, GQA attention (sliding window,
QKV bias, a given softmax scale), MLPs, MoE (capacity-limited, and a dropless
expert-parallel share), embedding and head.

The PyTorch counterpart of ``src/repro/models/layers.py``: the layers every
family of the model zoo serves and trains with.  Parameters are :class:`Tree`
modules with the JAX package's names and layouts (a linear weight is
``[d_in, d_out]``), and the functions here take such a tree and tensors, as
the JAX functions take a pytree.  Activations run in ``cfg.dtype``; norms,
RoPE and the softmax compute in f32 and round where the JAX functions
round.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import full as dtensor_full
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import NEG_INF, default_scale, flash_attention
from ..sharding import cache_shardings

# ---------------------------------------------------------------------------
# DTensor placements (the dry-run traces the models over DTensors; on a
# plain tensor these helpers return it as it is)


def replicate_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums reduced (an all-reduce over the mesh dims
    where it is ``Partial``): a vocab-sharded embedding's rows, before a
    nonlinear op that cannot take partial values."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        # the gradient arrives replicated, as the backward of a masked
        # partial sum needs it
        return settle_grad(t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements]))
    return t


def heads(t: torch.Tensor, n: int, hd: int, kv_heads: int) -> torch.Tensor:
    """``t [..., n*hd]`` as ``[..., n, hd]``.  A DTensor sharded on its last
    dim keeps that shard only over mesh dims that divide ``kv_heads`` (so
    the shard stays on whole heads, and on whole KV groups when the query
    heads split as ``[K, G]``); over the others it is gathered first."""
    if isinstance(t, DTensor):
        t = replicate_partial(t)
        mesh = t.device_mesh
        pl = [Replicate() if p.is_shard(t.dim() - 1) and kv_heads % mesh.size(i)
              else p for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


class _SettleGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous and, on a DTensor, placed
    as the forward value was (pending sums reduced).  A gradient that a
    per-shard function gives back keeps that function's layout (an
    einsum's permuted one) under a contiguous global shape, and DTensor's
    backward can pick placements that a later view cannot split; either
    would fail at the next view of it."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = (t.placements if isinstance(t, DTensor) else None)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.placements is not None:
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_partial() else p for p in ctx.placements])
        return g.contiguous()


def settle_grad(t: torch.Tensor) -> torch.Tensor:
    return _SettleGrad.apply(t) if t.requires_grad else t


def _dense_grads(fn):
    def wrapped(*args):
        return fn(*(settle_grad(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    return wrapped


def batch_placements(mesh, batch: int, heads: Optional[int] = None) -> list:
    """Per mesh dim: dim 0 (the batch) over the data axes (``pod``,
    ``data``) where their product divides ``batch``; dim 2 (the heads of
    ``[B,S,K,...]``) over ``model`` where ``heads`` is given and ``model``
    divides it; else replicated.  Pinned, so that a dry-run's per-card counts do not depend
    on DTensor's propagation choices."""
    names = mesh.mesh_dim_names
    data = [i for i, n in enumerate(names) if n in ("pod", "data")]
    shard_batch = batch % math.prod(mesh.size(i) for i in data) == 0
    out = []
    for i, n in enumerate(names):
        if i in data and shard_batch:
            out.append(Shard(0))
        elif n == "model" and heads is not None and heads % mesh.size(i) == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def regroup(t: torch.Tensor, sizes, dim: int, placements) -> list:
    """``torch.split(t, sizes, dim)``; on a DTensor, piece ``i`` placed as
    ``placements[i]``.  The pieces' bounds need not fall on ``t``'s shard
    bounds, so ``t`` is first gathered over the mesh dims that shard
    ``dim`` (a collective), and each piece is re-sharded from there (a
    local slice)."""
    if not isinstance(t, DTensor):
        return torch.split(t, sizes, dim)
    dim %= t.dim()
    mesh = t.device_mesh
    t = replicate_partial(t).redistribute(mesh, [
        Replicate() if p.is_shard(dim) else p for p in t.placements])
    # slices rather than torch.split: split's sharding strategy differs
    # between torch versions
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    return [t.narrow(dim, o, n).redistribute(mesh, pl)
            for o, n, pl in zip(offsets, sizes, placements)]


# ---------------------------------------------------------------------------
# initializers


def _normal(shape, dtype, scale, generator: torch.Generator) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def remat(cfg, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its activations recomputed in the
    backward when ``cfg.remat`` is set and autograd is recording: the
    layer bodies the JAX package wraps in ``jax.checkpoint``.  Serving and
    decode (no grad) call ``fn`` as it is.  The bodies draw no random
    numbers, so no RNG state is stashed for the recompute."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)


class Tree(nn.Module):
    """Nested dicts of tensors as a module, indexed like the dicts: a tensor
    becomes a frozen parameter, a dict a subtree.  ``requires_grad_()`` on
    the model makes every weight trainable (the train step does)."""

    def __init__(self, obj: dict):
        super().__init__()
        for k, v in obj.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, _param(v))
            else:
                self.add_module(k, Tree(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class TreeLM(nn.Module):
    """A language model whose weights are :class:`Tree` modules in the JAX
    package's layout: top-level parameters (``embed``, ``ln_f``, ``head``,
    ...) in ``params`` and one tree per layer in ``layers``.  A subclass's
    ``init`` draws them from a generator; :meth:`load` takes them as nested
    dicts of tensors (see ``models.convert.model_from_numpy``)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ModuleDict()
        self.layers = nn.ModuleList()

    def load(self, params: dict, layers: list):
        self.params = Tree(params)
        self.layers = nn.ModuleList(Tree(lp) for lp in layers)
        return self

    def loss(self, batch: dict) -> torch.Tensor:
        """Next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` shifted by one, plus ``0.01 * aux`` (the MoE
        layers' summed load-balancing loss; 0 for the other families), as
        the JAX package's ``DecoderLM.loss``, ``Mamba2LM.loss`` and
        ``Zamba2LM.loss``."""
        logits, aux = self.forward(batch["tokens"])
        ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                           batch.get("mask", None))
        return ce + 0.01 * aux

    def _logits(self, x):
        """Final norm, then the tied embedding or the head; f32 logits."""
        cfg = self.cfg
        x = rms_norm(self.params["ln_f"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return unembed(self.params["embed"], x)
        return linear(self.params["head"], x).float()


def init_linear(d_in, d_out, dtype, generator, bias=False, scale=None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal((d_in, d_out), dtype, scale, generator)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def tp_input(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` placed for ``x @ w`` (``w`` ``[d_in, d_out]``) as Megatron
    places it: replicated over the mesh dims that shard ``w``'s outputs
    (column-parallel), sharded on its last dim over those that shard
    ``w``'s inputs (row-parallel), replicated where ``w`` is and ``x`` is
    sharded on its last dim (a gather of ``x``, not a partial sum of the
    product); as it is elsewhere.  Left to itself, DTensor may keep ``x``
    sharded on the batch over such a dim and gather the weight instead."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    pl = [Replicate() if wp.is_shard(1) else Shard(last) if wp.is_shard(0)
          else Replicate() if xp.is_shard(last) else xp
          for xp, wp in zip(x.placements, w.placements)]
    if pl == list(x.placements):
        return x
    return replicate_partial(x).redistribute(x.device_mesh, pl)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    x = tp_input(x, p["w"])
    y = x @ p["w"].to(x.dtype)
    if isinstance(y, DTensor) and any(q.is_partial() for q in y.placements):
        # row-parallel: the gradient arrives replicated, so the backward's
        # products stay on this card's rows (a partial gradient would have
        # DTensor gather the weight and run the whole product instead)
        y = settle_grad(y)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def linear_split(p, x: torch.Tensor, sizes, placements) -> list:
    """``torch.split(linear(p, x), sizes, -1)`` (no bias); on a DTensor,
    piece ``i`` placed as ``placements[i]`` (per mesh dim: the batch's
    shard, and a shard of the last dim where the piece splits over that
    dim).  Each card computes its own columns of each piece.  Since the
    pieces' bounds need not fall on the weight's shard bounds, one side is
    gathered: the weight (then split, each piece's columns re-sharded)
    where it has fewer bytes than the input (many tokens: training and
    prefill), else the output (few tokens: a decode step)."""
    if not isinstance(x, DTensor):
        return torch.split(linear(p, x), sizes, -1)
    w, last = p["w"], x.dim() - 1
    tokens = x.to_local().numel() // x.shape[-1]
    if w.shape[0] * w.element_size() < tokens * x.element_size():
        wpl = [[Shard(1) if a.is_shard(last) else Replicate() for a in pl]
               for pl in placements]
        return [linear({"w": wi}, x).redistribute(x.device_mesh, pl)
                for wi, pl in zip(regroup(w, sizes, 1, wpl), placements)]
    return regroup(linear(p, x), sizes, -1, placements)


def init_norm(d, dtype, device) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["g"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Rotates the
    split halves of hd (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].float() * inv               # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention


def init_attention(cfg, generator) -> dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": init_linear(d, H * hd, cfg.pdt, generator, bias=cfg.qkv_bias),
        "wk": init_linear(d, K * hd, cfg.pdt, generator, bias=cfg.qkv_bias),
        "wv": init_linear(d, K * hd, cfg.pdt, generator, bias=cfg.qkv_bias),
        "wo": init_linear(H * hd, d, cfg.pdt, generator,
                          scale=1.0 / math.sqrt(H * hd * 2 * cfg.num_layers)),
    }


FLASH_THRESHOLD = 4096 * 4096   # S*T above which blockwise attention is used


def _sdpa(q, k, v, mask, *, use_kernel: bool = False, causal: bool = False,
          window: Optional[int] = None, scale: Optional[float] = None):
    """Grouped scaled-dot-product attention.

    q: [B,S,K,G,hd] (G = query groups per kv head), k/v: [B,T,K,hd],
    mask: [B,1,S,T] or broadcastable boolean (True = attend).  The logits
    are scaled by ``scale``, ``1/sqrt(hd)`` when it is None.

    ``use_kernel`` and long causal prefills (S*T above ``FLASH_THRESHOLD``)
    take :func:`flash_attention`: kernel B3 on the card, its plain version on
    the CPU.  Otherwise the logits are materialised as the JAX einsum path
    does: rounded to the activation dtype before the f32 scale, and the
    softmax weights rounded back before the second product.
    """
    S, T = q.shape[1], k.shape[1]
    if isinstance(q, DTensor):
        # batch over the data axes, KV heads over model where it divides
        # them: B3's sharding rule, and the per-shard einsums' below
        pl = batch_placements(q.device_mesh, q.shape[0], q.shape[2])
        q, k, v = (t.redistribute(t.device_mesh, pl) for t in (q, k, v))
    if S > 1 and (use_kernel or (causal and S * T > FLASH_THRESHOLD)):
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if isinstance(q, DTensor):
        # per shard of batch and KV heads (DTensor cannot split the
        # einsums' merged batch dims)
        mpl = ([Replicate() for _ in pl] if isinstance(mask, DTensor)
               else None)
        return local_map(_dense_grads(functools.partial(_sdpa_einsum,
                                                        scale=scale)),
                         out_placements=pl, in_placements=(pl, pl, pl, mpl),
                         redistribute_inputs=True)(q, k, v, mask)
    return _sdpa_einsum(q, k, v, mask, scale)


def _sdpa_einsum(q, k, v, mask, scale: Optional[float] = None):
    scale = default_scale(q.shape[-1], scale)
    logits = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    logits = torch.where(mask[:, None, None] if mask.dim() == 3 else mask,
                         logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v)


def causal_mask(S: int, T: int, offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """[S,T] boolean mask; query i attends key j iff j <= i+offset (and
    within the sliding window if given)."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention(p, cfg, x, positions, mask, kv=None, *, use_kernel=False,
              causal=False, scale: Optional[float] = None):
    """kv: optional (k, v) override for cross-attention / cached decode;
    ``scale``: the softmax scale, ``1/sqrt(hd)`` when None."""
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if cfg.ablate_attention and kv is None:
        # measurement-only path: QKV/O projections run, the O(S*T) mixing is
        # skipped, as in the JAX package
        qa = linear(p["wq"], x)
        ka = heads(linear(p["wk"], x), K, hd, K)
        va = heads(linear(p["wv"], x), K, hd, K)
        return linear(p["wo"], qa * 0.001), (ka, va)
    G = H // K
    q = heads(linear(p["wq"], x), H, hd, K)
    q = apply_rope(q, positions, cfg.rope_theta) if cfg.rope_theta else q
    if kv is None:
        k = heads(linear(p["wk"], x), K, hd, K)
        v = heads(linear(p["wv"], x), K, hd, K)
        k = apply_rope(k, positions, cfg.rope_theta) if cfg.rope_theta else k
    else:
        k, v = kv
    qg = q.reshape(B, S, K, G, hd)
    out = _sdpa(qg, k, v, mask, use_kernel=use_kernel, causal=causal,
                window=cfg.sliding_window, scale=scale)
    out = out.reshape(B, S, H * hd)
    return linear(p["wo"], out), (k, v)


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(cfg, generator, d_ff=None) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    out_scale = 1.0 / math.sqrt(d_ff * 2 * cfg.num_layers)
    p = {"wi": init_linear(d, d_ff, cfg.pdt, generator)}
    if cfg.mlp == "swiglu":
        p["wg"] = init_linear(d, d_ff, cfg.pdt, generator)
    p["wo"] = init_linear(d_ff, d, cfg.pdt, generator, scale=out_scale)
    return p


def mlp(p, cfg, x):
    if cfg.mlp == "swiglu":
        h = F.silu(linear(p["wg"], x)) * linear(p["wi"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p["wi"], x), approximate="tanh")
    return linear(p["wo"], h)


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style grouped top-k dispatch with capacity)


def init_moe(cfg, generator) -> dict:
    d, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(F_ * 2 * cfg.num_layers)
    return {
        "router": init_linear(d, E, torch.float32, generator),
        "wi": _normal((E, d, F_), cfg.pdt, s_in, generator),
        "wg": _normal((E, d, F_), cfg.pdt, s_in, generator),
        "wo": _normal((E, F_, d), cfg.pdt, s_out, generator),
    }


def moe(p, cfg, x, *, group_size: int = 512):
    """Top-k routed MoE with per-group expert capacity (token dropping), step
    for step as the JAX package's ``moe``: f32 router, the Switch aux loss,
    K rounds of argmax (the first maximal index, as ``jnp.argmax``) filling
    ``C = ceil(K Gs / E * capacity_factor)`` slots per expert and group, the
    renormalised ``combine`` and ``dispatch = combine > 0`` as dense
    ``[G, Gs, E, C]`` tensors, the experts as batched einsums.  A token
    count ``B * S`` that ``group_size`` does not divide is refused, as the
    reference refuses it.  Returns ``(out, aux)``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    tokens = x.reshape(-1, D)
    N = tokens.shape[0]
    Gs = min(group_size, N)
    if N % Gs:
        raise ValueError(f"token count {N} not divisible by group {Gs}")
    G = N // Gs
    C = max(1, int(math.ceil(K * Gs / E * cfg.capacity_factor)))
    xg = tokens.reshape(G, Gs, D)

    logits = xg.float() @ p["router"]["w"]                      # [G,Gs,E]
    probs = torch.softmax(logits, dim=-1)

    # load-balancing aux loss (Switch): E * mean(frac_tokens * frac_probs)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.mean(F.one_hot(top1, E).float(), dim=1)
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    # iterative top-k with capacity assignment
    combine = torch.zeros((G, Gs, E, C), dtype=torch.float32, device=x.device)
    remaining = probs
    fill = torch.zeros((G, E), dtype=torch.int32, device=x.device)
    for _ in range(K):
        idx = torch.argmax(remaining, dim=-1)                   # [G,Gs]
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, E).float()                      # [G,Gs,E]
        pos = torch.cumsum(onehot, dim=1) - onehot              # pos within group
        pos = pos + fill[:, None, :]                            # offset by filled
        in_cap = pos < C
        slot = torch.sum(onehot * pos, dim=-1).to(torch.int32)
        keep = torch.sum(onehot * in_cap, dim=-1) > 0
        cslot = F.one_hot(torch.clamp(slot, 0, C - 1).long(), C).float()
        combine = combine + (gate * keep)[..., None, None] * \
            onehot[..., None] * cslot[:, :, None, :]
        fill = fill + torch.sum(onehot * in_cap, dim=1).to(torch.int32)
        remaining = remaining * (1.0 - onehot)

    # renormalize kept gates over the k choices (granite-style top-k softmax)
    denom = torch.sum(combine, dim=(2, 3), keepdim=True) + 1e-9
    combine = combine / denom
    out = _experts(combine, xg, p["wg"].to(x.dtype), p["wi"].to(x.dtype),
                   p["wo"].to(x.dtype))
    out = out.reshape(B, S, D)
    return (settle_grad(out) if isinstance(out, DTensor) else out), aux


def _dispatch_experts(combine, xg, wg, wi, wo):
    """Dispatch ``xg [G,Gs,D]`` by ``combine [G,Gs,E,C]`` to the experts'
    slots, run the experts' SwiGLU, and combine their outputs back."""
    dispatch = (combine > 0).to(xg.dtype)                       # [G,Gs,E,C]
    xin = torch.einsum("gsec,gsd->egcd", dispatch, xg)          # [E,G,C,D]
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, wg))
    h = h * torch.einsum("egcd,edf->egcf", xin, wi)
    out_e = torch.einsum("egcf,efd->egcd", h, wo)
    return torch.einsum("gsec,egcd->gsd", combine.to(xg.dtype), out_e)


def _experts(combine, xg, wg, wi, wo):
    """:func:`_dispatch_experts`; on DTensors, per shard.  Over a mesh dim
    that shards the expert weights (EP), each card runs its experts on
    every token of its group shard and the output is a partial sum; over a
    batch dim (groups, or tokens within the one group of a decode step)
    each card runs its tokens, and each slot holds one token, so the
    per-shard dispatch is exact."""
    if not isinstance(xg, DTensor):
        return _dispatch_experts(combine, xg, wg, wi, wo)
    cpl, xpl, wpl, opl, xgrad, wgrad = [], [], [], [], [], []
    for w, c in zip(wg.placements, combine.placements):
        batch = next((d for d in (0, 1) if c.is_shard(d)), None)
        if w.is_shard(0):
            cpl.append(Shard(2)), xpl.append(Replicate())
            opl.append(Partial()), xgrad.append(Partial())
            wgrad.append(w)
        elif batch is not None:
            cpl.append(Shard(batch)), xpl.append(Shard(batch))
            opl.append(Shard(batch)), xgrad.append(Shard(batch))
            wgrad.append(Partial())
        else:
            cpl.append(Replicate()), xpl.append(Replicate())
            opl.append(Replicate()), xgrad.append(Replicate())
            wgrad.append(Replicate())
        wpl.append(w)
    return local_map(_dispatch_experts, out_placements=opl,
                     in_placements=(cpl, xpl, wpl, wpl, wpl),
                     in_grad_placements=(cpl, xgrad, wgrad, wgrad, wgrad),
                     redistribute_inputs=True)(combine, xg, wg, wi, wo)


# ---------------------------------------------------------------------------
# Mixture of Experts, dropless, over the experts held here (expert
# parallelism: every share routes over all experts and computes its own)

_moe_count_lock = threading.Lock()


def moe_dropless(p, x, *, top_k: int, held: range, layer=0):
    """Top-``top_k`` routed MoE with no token dropped, over the experts
    ``held`` of the router's outputs, as one card of an expert-parallel
    group computes its share (without the exchange).

    ``p["router"]["w"]`` is ``[D, E]`` (every expert's logit, f32);
    ``p["wg"]``, ``p["wi"]`` ``[n, D, F]`` and ``p["wo"]`` ``[n, F, D]`` hold
    the ``n = len(held)`` experts held here.  Each token takes the ``top_k``
    largest logits (``torch.topk``) and the softmax over those alone as its
    gates; an assignment to a held expert adds ``gate * wo(silu(wg x) * wi
    x)``, and an assignment to an expert held elsewhere adds nothing here.
    A stable sort on the expert puts the held experts' rows first, in
    expert order; each of the three products is one grouped product
    (``torch._grouped_mm``, rows of ``D`` and ``F`` a multiple of 16 bytes)
    over those rows, the groups' ends kept on the card; the gated rows are
    summed back per token in f32.  The row counts come to the host once a
    call (range ``moe.row_counts``) and size the rows: without them every
    tensor would be sized for ``N * min(top_k, n)`` rows, the most a call
    can route here, seven times the rows that 9 of 72 experts at top-10
    take at even routing.

    Counters, summed over calls (a training step under ``cfg.remat`` calls
    each layer twice: forward and recompute): ``moe_dropless.assigned``
    ``{(layer, expert): assignments computed}``, ``moe_dropless.absent``
    (assignments to experts not held here, left out) and
    ``moe_dropless.dropped`` (assignments to held experts not computed:
    0).  Returns the ``[B, S, D]`` output in ``x``'s dtype."""
    B, S, D = x.shape
    n = len(held)
    tokens = x.reshape(-1, D)
    N = tokens.shape[0]
    logits = tokens.float() @ p["router"]["w"].float()          # [N,E]
    top, idx = torch.topk(logits, top_k, dim=-1)                # [N,K]
    gates = torch.softmax(top, dim=-1)
    local = idx - held.start
    expert = torch.where((local >= 0) & (local < n), local, n).reshape(-1)
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=n + 1)            # [n+1]
    with torch.profiler.record_function("moe.row_counts"):
        host = counts.tolist()
    M = sum(host[:n])
    pick = order[:M]
    row = pick // top_k                                         # [M]
    gate = gates.reshape(-1)[pick]
    xs = tokens[row]                                            # [M,D]
    if M:
        ends = torch.cumsum(counts[:n], 0).to(torch.int32)
        wg, wi, wo = (p[k].to(x.dtype) for k in ("wg", "wi", "wo"))
        h = F.silu(torch._grouped_mm(xs, wg, offs=ends)) * \
            torch._grouped_mm(xs, wi, offs=ends)
        y = torch._grouped_mm(h, wo, offs=ends)                 # [M,D]
    else:
        y = xs
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    out = out.index_add(0, row, y.float() * gate[:, None])
    with _moe_count_lock:
        for e, c in zip(held, host):
            key = (layer, e)
            moe_dropless.assigned[key] = moe_dropless.assigned.get(key, 0) + c
        moe_dropless.absent += host[n]
        moe_dropless.dropped += M - y.shape[0]
    return out.to(x.dtype).reshape(B, S, D)


moe_dropless.assigned = {}
moe_dropless.absent = 0
moe_dropless.dropped = 0


def new_cache(init_cache, B: int, max_len: int, like: torch.Tensor) -> dict:
    """``init_cache(B, max_len, like.device)``.  For a DTensor ``like`` (a
    dry-run's trace) each tensor is made as a DTensor under the decode
    cache's shardings, without a global copy: zeros, and -1 for ``kpos``,
    as ``init_cache`` fills them."""
    if not isinstance(like, DTensor):
        return init_cache(B, max_len, like.device)
    meta = init_cache(B, max_len, "meta")
    mesh = like.device_mesh
    shard = cache_shardings(meta, mesh)
    return {k: dtensor_full(v.shape, -1 if k == "kpos" else 0, dtype=v.dtype,
                            device_mesh=mesh, placements=shard[k].placements)
            if k in shard else v for k, v in meta.items()}


# ---------------------------------------------------------------------------
# embedding / head


def init_embedding(vocab, d, dtype, generator) -> dict:
    return {"e": _normal((vocab, d), dtype, 0.02, generator)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    # F.embedding rather than indexing: its gradient on the CPU sums the
    # rows in a fixed order (indexing's accumulates in a varying one)
    return replicate_partial(F.embedding(ids, p["e"]))


def unembed(p, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    w = p["e"].t()
    return (tp_input(x, w) @ w.to(x.dtype)).to(dtype)


def _vocab_sharded(logits: DTensor) -> bool:
    mesh, vdim = logits.device_mesh, logits.dim() - 1
    return any(p.is_shard(vdim) and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _picked_logit(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """``logits[..., label]`` of a DTensor, per shard: each shard gathers the
    labels that fall in its slice of the vocab, and the result is a
    partial sum over the vocab's mesh dims (none if it is not sharded)."""
    mesh, vdim = logits.device_mesh, logits.dim() - 1
    size, offset = logits.shape[-1], 0
    for i, p in enumerate(logits.placements):
        if p.is_shard(vdim):
            size, off = Shard.local_shard_size_and_offset(
                size, mesh.size(i), mesh.get_local_rank(i))
            offset += off

    def local(lg, lb):
        idx = lb.long() - offset
        ok = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, torch.where(ok, idx, 0)[..., None])[..., 0]
        return torch.where(ok, got, 0.0)

    lpl = [Partial() if p.is_shard(vdim) else p for p in logits.placements]
    bpl = [Replicate() if p.is_shard(vdim) else p for p in logits.placements]
    return local_map(local, out_placements=lpl,
                     in_placements=(list(logits.placements), bpl),
                     redistribute_inputs=True)(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy in f32; with ``mask``, the masked mean."""
    logits = replicate_partial(logits.float())
    if not isinstance(logits, DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None].long())
    elif _vocab_sharded(logits):
        # vocab-parallel: the max, the sum of exponentials and the picked
        # logit reduce over the shards ([B,S] all-reduces), and the logits
        # are never gathered
        m = replicate_partial(logits.detach().amax(-1, keepdim=True))
        lse = torch.log(replicate_partial(
            torch.sum(torch.exp(logits - m), dim=-1))) + m[..., 0]
        picked = replicate_partial(_picked_logit(logits, labels))[..., None]
    else:
        # a shard of the vocab over mesh dims of size 1 is the whole vocab
        # (no data moves); the gather runs per shard, since DTensor's own
        # gather backward makes its zeros at the global shape on each card
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_shard(logits.dim() - 1) else p
            for p in logits.placements])
        lse = torch.logsumexp(logits, dim=-1)
        picked = _picked_logit(logits, labels)[..., None]
    ll = picked[..., 0] - lse
    loss = -ll
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), 1)
    return torch.mean(loss)
