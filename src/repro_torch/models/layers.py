"""Core layers of the models: norms, RoPE, GQA attention (sliding window,
QKV bias), MLPs, MoE, embedding and head.

The PyTorch counterpart of ``src/repro/models/layers.py``: the layers every
family of the model zoo serves and trains with.  Parameters are :class:`Tree`
modules with the JAX package's names and layouts (a linear weight is
``[d_in, d_out]``), and the functions here take such a tree and tensors, as
the JAX functions take a pytree.  Activations run in ``cfg.dtype``; norms,
RoPE and the softmax compute in f32 and round where the JAX functions
round.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import NEG_INF, flash_attention

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


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


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
          window: Optional[int] = None):
    """Grouped scaled-dot-product attention.

    q: [B,S,K,G,hd] (G = query groups per kv head), k/v: [B,T,K,hd],
    mask: [B,1,S,T] or broadcastable boolean (True = attend).

    ``use_kernel`` and long causal prefills (S*T above ``FLASH_THRESHOLD``)
    take :func:`flash_attention`: kernel B3 on the card, its plain version on
    the CPU.  Otherwise the logits are materialised as the JAX einsum path
    does: rounded to the activation dtype before the f32 scale, and the
    softmax weights rounded back before the second product.
    """
    S, T = q.shape[1], k.shape[1]
    if S > 1 and (use_kernel or (causal and S * T > FLASH_THRESHOLD)):
        return flash_attention(q, k, v, causal=causal, window=window)
    scale = 1.0 / math.sqrt(q.shape[-1])
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
              causal=False):
    """kv: optional (k, v) override for cross-attention / cached decode."""
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if cfg.ablate_attention and kv is None:
        # measurement-only path: QKV/O projections run, the O(S*T) mixing is
        # skipped, as in the JAX package
        qa = linear(p["wq"], x)
        ka = linear(p["wk"], x).reshape(B, S, K, hd)
        va = linear(p["wv"], x).reshape(B, S, K, hd)
        return linear(p["wo"], qa * 0.001), (ka, va)
    G = H // K
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    q = apply_rope(q, positions, cfg.rope_theta) if cfg.rope_theta else q
    if kv is None:
        k = linear(p["wk"], x).reshape(B, S, K, hd)
        v = linear(p["wv"], x).reshape(B, S, K, hd)
        k = apply_rope(k, positions, cfg.rope_theta) if cfg.rope_theta else k
    else:
        k, v = kv
    qg = q.reshape(B, S, K, G, hd)
    out = _sdpa(qg, k, v, mask, use_kernel=use_kernel, causal=causal,
                window=cfg.sliding_window)
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
    dispatch = (combine > 0).to(x.dtype)                        # [G,Gs,E,C]

    xin = torch.einsum("gsec,gsd->egcd", dispatch, xg)          # [E,G,C,D]
    h = F.silu(torch.einsum("egcd,edf->egcf", xin, p["wg"].to(x.dtype)))
    h = h * torch.einsum("egcd,edf->egcf", xin, p["wi"].to(x.dtype))
    out_e = torch.einsum("egcf,efd->egcd", h, p["wo"].to(x.dtype))
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out_e)
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# embedding / head


def init_embedding(vocab, d, dtype, generator) -> dict:
    return {"e": _normal((vocab, d), dtype, 0.02, generator)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    # F.embedding rather than indexing: its gradient on the CPU sums the
    # rows in a fixed order (indexing's accumulates in a varying one)
    return F.embedding(ids, p["e"])


def unembed(p, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (x @ p["e"].t().to(x.dtype)).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy in f32; with ``mask``, the masked mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0] - lse
    loss = -ll
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), 1)
    return torch.mean(loss)
