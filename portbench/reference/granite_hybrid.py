"""Granite-4.0-H's layer equations (``granitemoehybrid``) in plain PyTorch:
the reference of the granite cell, one card's share of an expert-parallel
deployment.  Float32 unless told otherwise; the caller turns TF32 off
(``reference.no_tf32``).  Written from the published equations, with
nothing of the program: its own SSD (chunks of the published 256), its own
attention in query blocks, its own routing, expert by expert.

With ``r`` the residual multiplier, per layer::

    h  = x + r * mixer(RMSNorm(x))            Mamba2 or attention, by layer_types
    x' = h + r * (MoE(u) + Shared(u)),        u = RMSNorm(h)
    x0 = embedding_multiplier * E[ids];  logits = RMSNorm(x_L) E^T / logits_scaling

    Mamba2:    [z | xBC | dt] = in_proj(u);  xBC = silu(conv1d_causal(xBC) + b)
               x, B, C = split(xBC);  dt = softplus(dt + dt_bias);  A = -exp(A_log)
               y = SSD(x dt, dt A, B, C) + D x;  out_proj(RMSNorm(y * silu(z)))
    attention: softmax(attention_multiplier q k^T + causal mask) v, no rotary,
               query head j reads KV head j // (heads / kv_heads)
    MoE:       the router's logits over every expert; top-k; gates the softmax
               over those k logits; the sum of gate * W2(silu(W1g u) * W1u u)
               over the chosen experts that are held here, none dropped

Weights are a flat dict under the names the program's ``named_parameters``
gives (:func:`init_weights` draws them from a generator).  Products go
through :class:`Products`, which rounds their inputs to float8 e4m3 for the
``fp8_products`` control; ``route="capacity"`` routes as GShard does, in
groups with a capacity per expert (the ``dropped_tokens`` control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CONV_WIDTH = 4
QUERY_BLOCK = 1024          # attention's query rows per block
FP8_MAX = 448.0             # the largest float8 e4m3 (fn) value


@dataclass(frozen=True)
class Spec:
    """The shapes and multipliers the equations need, under the model's
    ``config.json`` names where it has one."""
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    intermediate_size: int          # one expert's width
    shared_intermediate_size: int
    vocab_size: int                 # the rows held here
    layer_types: tuple
    router_experts: int             # the router's outputs
    experts_held: int
    expert_rank: int
    num_experts_per_tok: int
    mamba_n_heads: int
    mamba_d_head: int
    mamba_d_state: int
    mamba_chunk_size: int
    attention_multiplier: float
    embedding_multiplier: float
    residual_multiplier: float
    logits_scaling: float
    rms_norm_eps: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        return cls(**{k: (tuple(cfg[k]) if k == "layer_types" else cfg[k])
                      for k in cls.__dataclass_fields__ if k in cfg}
                   | {"experts_held": cfg["num_local_experts"]})

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def d_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def held(self) -> range:
        n = self.experts_held
        return range(self.expert_rank * n, (self.expert_rank + 1) * n)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, as float8 products take their inputs; the
    gradient passes as if unrounded."""
    if t.numel() == 0:
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    r = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (r - t.detach())


class Products:
    """Matrix products, exact in the operands' dtype or (``fp8``) with
    every input rounded to float8 e4m3 first."""

    def __init__(self, fp8: bool = False):
        self.round = fp8_round if fp8 else (lambda t: t)

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self.round(o) for o in ops))


EXACT = Products()


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


# ---------------------------------------------------------------------------
# weights


def weight_shapes(spec: Spec) -> dict:
    """Name -> shape of every weight held here, in drawing order."""
    d, V, E = spec.hidden_size, spec.vocab_size, spec.router_experts
    H, K, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    di, n, h = spec.d_inner, spec.mamba_d_state, spec.mamba_n_heads
    F_, Fs, m = spec.intermediate_size, spec.shared_intermediate_size, \
        spec.experts_held
    out = {"params.embed.e": (V, d), "params.ln_f.g": (d,)}
    for i, kind in enumerate(spec.layer_types):
        p = f"layers.{i}."
        if kind == "mamba":
            out |= {p + "mamba.ln.g": (d,),
                    p + "mamba.in_proj.w": (d, 2 * di + 2 * n + h),
                    p + "mamba.conv_w": (CONV_WIDTH, di + 2 * n),
                    p + "mamba.conv_b": (di + 2 * n,),
                    p + "mamba.A_log": (h,), p + "mamba.D": (h,),
                    p + "mamba.dt_bias": (h,), p + "mamba.norm.g": (di,),
                    p + "mamba.out_proj.w": (di, d)}
        else:
            out |= {p + "ln1.g": (d,), p + "attn.wq.w": (d, H * hd),
                    p + "attn.wk.w": (d, K * hd), p + "attn.wv.w": (d, K * hd),
                    p + "attn.wo.w": (H * hd, d)}
        out |= {p + "ln2.g": (d,), p + "moe.router.w": (d, E),
                p + "moe.wg": (m, d, F_), p + "moe.wi": (m, d, F_),
                p + "moe.wo": (m, F_, d), p + "shared.wg.w": (d, Fs),
                p + "shared.wi.w": (d, Fs), p + "shared.wo.w": (Fs, d)}
    return out


def init_weights(spec: Spec, generator: torch.Generator) -> dict:
    """Float32 weights drawn from ``generator`` on its device: products
    normal with variance 1 / fan-in, the embedding with standard deviation
    0.02, norms 1, conv bias 0, ``A_log = log(1..16)`` and ``dt`` from 0.001
    to 0.1 over the heads (Mamba2's ranges), ``D`` 1."""
    dev = generator.device
    out = {}
    for name, shape in weight_shapes(spec).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "g" or name.endswith(".D"):
            t = torch.ones(shape, device=dev)
        elif name.endswith("conv_b"):
            t = torch.zeros(shape, device=dev)
        elif name.endswith("A_log"):
            t = torch.log(torch.linspace(1.0, 16.0, shape[0], device=dev))
        elif name.endswith("dt_bias"):
            dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                          shape[0], device=dev))
            t = dt + torch.log(-torch.expm1(-dt))       # softplus^-1(dt)
        else:
            std = 0.02 if name == "params.embed.e" else shape[-2] ** -0.5
            t = torch.randn(shape, generator=generator, device=dev) * std
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# mixers


def ssd(x, a, B, C, chunk: int, prod: Products = EXACT):
    """``y_t = sum_{j <= t} C_t . B_j exp(a_{j+1} + ... + a_t) x_j`` for x
    ``[b,s,h,p]``, log-decays a ``[b,s,h]``, B, C ``[b,s,n]``: within each
    chunk the masked quadratic form, across chunks the carried state."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = -s % chunk
    if pad:
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    c = (s + pad) // chunk
    x = x.reshape(b, c, chunk, h, p)
    B, C = B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n)
    cs = a.reshape(b, c, chunk, h).cumsum(2)                      # [b,c,L,h]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    seg = torch.where(causal, cs[:, :, :, None] - cs[:, :, None], -math.inf)
    scores = prod.einsum("bcin,bcjn->bcij", C, B)[..., None] * seg.exp()
    y = prod.einsum("bcijh,bcjhp->bcihp", scores, x)
    to_end = (cs[:, :, -1:] - cs).exp()                           # [b,c,L,h]
    states = prod.einsum("bcjhp,bcjn->bchpn", x * to_end[..., None], B)
    state = x.new_zeros(b, h, p, n)
    carried = []
    for k in range(c):
        carried.append(state)
        state = cs[:, k, -1, :, None, None].exp() * state + states[:, k]
    carried = torch.stack(carried, 1)                             # [b,c,h,p,n]
    y = y + prod.einsum("bcin,bchpn->bcihp", C, carried) * cs.exp()[..., None]
    return y.reshape(b, c * chunk, h, p)[:, :s]


def mamba(spec: Spec, w: dict, p: str, x, prod: Products = EXACT):
    """The Mamba2 mixer of layer prefix ``p`` (its input norm included)."""
    b, s, _ = x.shape
    di, n, h = spec.d_inner, spec.mamba_d_state, spec.mamba_n_heads
    u = rms_norm(x, w[p + "ln.g"], spec.rms_norm_eps)
    z, xBC, dt = torch.split(prod.mm(u, w[p + "in_proj.w"]),
                             [di, di + 2 * n, h], -1)
    padded = F.pad(xBC, (0, 0, CONV_WIDTH - 1, 0))
    conv = sum(padded[:, i:i + s] * w[p + "conv_w"][i]
               for i in range(CONV_WIDTH))
    xs, Bm, Cm = torch.split(F.silu(conv + w[p + "conv_b"]), [di, n, n], -1)
    dt = F.softplus(dt + w[p + "dt_bias"])                        # [b,s,h]
    A = -torch.exp(w[p + "A_log"])
    xh = xs.reshape(b, s, h, spec.mamba_d_head)
    y = ssd(xh * dt[..., None], dt * A, Bm, Cm, spec.mamba_chunk_size, prod)
    y = (y + xh * w[p + "D"][:, None]).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), w[p + "norm.g"], spec.rms_norm_eps)
    return prod.mm(y, w[p + "out_proj.w"])


def _attention_block(q, k, v, s0: int, scale: float, prod: Products):
    """Queries ``s0 ..`` of ``q [b,q,H,hd]`` over keys ``0 .. s0 + q``."""
    nq, T = q.shape[1], k.shape[1]
    logits = prod.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = (torch.arange(T, device=q.device)[None, :]
            <= s0 + torch.arange(nq, device=q.device)[:, None])
    logits = torch.where(keep, logits, -math.inf)
    return prod.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def attention(spec: Spec, w: dict, p: str, u, prod: Products = EXACT):
    """Causal GQA attention of layer prefix ``p`` over the normed ``u``, in
    blocks of :data:`QUERY_BLOCK` queries (each recomputed in the backward
    where gradients are taken)."""
    b, s, _ = u.shape
    H, K, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    q = prod.mm(u, w[p + "attn.wq.w"]).reshape(b, s, H, hd)
    k = prod.mm(u, w[p + "attn.wk.w"]).reshape(b, s, K, hd)
    v = prod.mm(u, w[p + "attn.wv.w"]).reshape(b, s, K, hd)
    k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    out = []
    for s0 in range(0, s, QUERY_BLOCK):
        s1 = min(s, s0 + QUERY_BLOCK)
        args = (q[:, s0:s1], k[:, :s1], v[:, :s1], s0,
                spec.attention_multiplier, prod)
        out.append(checkpoint(_attention_block, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _attention_block(*args))
    return prod.mm(torch.cat(out, 1).reshape(b, s, H * hd),
                   w[p + "attn.wo.w"])


# ---------------------------------------------------------------------------
# experts


def route_top_k(logits, k: int):
    """Every token's ``k`` largest logits and the softmax over them:
    ``(experts [N,k], gates [N,k], kept [N,k])``, all kept."""
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, -1)
    return idx, gates, torch.ones_like(idx, dtype=torch.bool)


def route_capacity(logits, k: int, group: int = 512, factor: float = 1.0):
    """GShard's routing: per group of ``group`` tokens, ``k`` rounds of the
    largest remaining softmax probability, each expert taking at most
    ``ceil(k group / E * factor)`` assignments a group in token order (the
    rest dropped), gates renormalised over the kept ones."""
    N, E = logits.shape
    Gs = min(group, N)
    if N % Gs:
        raise ValueError(f"token count {N} not divisible by group {Gs}")
    cap = max(1, math.ceil(k * Gs / E * factor))
    remaining = torch.softmax(logits, -1).reshape(N // Gs, Gs, E)
    fill = torch.zeros(N // Gs, E, device=logits.device)
    idx, gates, kept = [], [], []
    for _ in range(k):
        e = remaining.argmax(-1)
        onehot = F.one_hot(e, E).to(remaining.dtype)
        pos = onehot.cumsum(1) - onehot + fill[:, None]
        fits = (onehot * (pos < cap)).sum(-1) > 0
        fill = fill + (onehot * (pos < cap)).sum(1)
        gates.append(remaining.gather(-1, e[..., None])[..., 0] * fits)
        idx.append(e)
        kept.append(fits)
        remaining = remaining * (1 - onehot)
    gates = torch.stack(gates, -1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return (torch.stack(idx, -1).reshape(N, k), gates.reshape(N, k),
            torch.stack(kept, -1).reshape(N, k))


def moe(spec: Spec, w: dict, p: str, u, prod: Products = EXACT,
        route: str = "dropless"):
    """The held experts' part of layer prefix ``p``'s MoE, expert by
    expert: what each held expert adds, gated, for the tokens routed to
    it; the experts held elsewhere add nothing here."""
    b, s, d = u.shape
    x = u.reshape(-1, d)
    logits = prod.mm(x, w[p + "moe.router.w"])
    k = spec.num_experts_per_tok
    idx, gates, kept = (route_top_k(logits, k) if route == "dropless"
                        else route_capacity(logits, k))
    out = torch.zeros_like(x)
    for j, e in enumerate(spec.held):
        tok, slot = torch.nonzero((idx == e) & kept, as_tuple=True)
        xe = x[tok]
        he = (F.silu(prod.mm(xe, w[p + "moe.wg"][j]))
              * prod.mm(xe, w[p + "moe.wi"][j]))
        out = out.index_add(0, tok, prod.mm(he, w[p + "moe.wo"][j])
                            * gates[tok, slot][:, None])
    return out.reshape(b, s, d)


def shared_expert(w: dict, p: str, u, prod: Products = EXACT):
    return prod.mm(F.silu(prod.mm(u, w[p + "shared.wg.w"]))
                   * prod.mm(u, w[p + "shared.wi.w"]), w[p + "shared.wo.w"])


# ---------------------------------------------------------------------------
# the model


def layer(spec: Spec, w: dict, i: int, x, prod: Products = EXACT,
          route: str = "dropless"):
    p, r, eps = f"layers.{i}.", spec.residual_multiplier, spec.rms_norm_eps
    if spec.layer_types[i] == "mamba":
        h = x + r * mamba(spec, w, p + "mamba.", x, prod)
    else:
        h = x + r * attention(spec, w, p, rms_norm(x, w[p + "ln1.g"], eps),
                              prod)
    u = rms_norm(h, w[p + "ln2.g"], eps)
    return h + r * (moe(spec, w, p, u, prod, route)
                    + shared_expert(w, p, u, prod))


def logits(spec: Spec, w: dict, ids, prod: Products = EXACT,
           route: str = "dropless"):
    """``[b, s, vocab]`` logits of token ids ``[b, s]``; each layer is
    recomputed in the backward where gradients are taken."""
    E = w["params.embed.e"]
    x = spec.embedding_multiplier * E[ids]
    for i in range(len(spec.layer_types)):
        if torch.is_grad_enabled():
            x = checkpoint(layer, spec, w, i, x, prod, route,
                           use_reentrant=False)
        else:
            x = layer(spec, w, i, x, prod, route)
    x = rms_norm(x, w["params.ln_f.g"], spec.rms_norm_eps)
    return prod.mm(x, E.t()) / spec.logits_scaling


def loss(spec: Spec, w: dict, ids, prod: Products = EXACT,
         route: str = "dropless"):
    """Mean cross entropy of each token's logits against the next token."""
    lg = logits(spec, w, ids, prod, route)
    return F.cross_entropy(lg[:, :-1].reshape(-1, lg.shape[-1]),
                           ids[:, 1:].reshape(-1))


def loss_and_grads(spec: Spec, w: dict, ids, names, prod: Products = EXACT,
                   route: str = "dropless") -> tuple[float, dict]:
    """The loss and its gradients with respect to the weights ``names``."""
    w = dict(w)
    for name in names:
        w[name] = w[name].detach().requires_grad_(True)
    value = loss(spec, w, ids, prod, route)
    grads = torch.autograd.grad(value, [w[n] for n in names])
    return float(value.detach()), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# the optimizer


def adamw_first_step(w, g, *, lr: float, b1: float, b2: float, eps: float,
                     weight_decay: float, clip_scale: float):
    """The change AdamW makes to ``w`` at its first step, in float64: from
    zero moments, the gradient ``g`` times ``clip_scale`` (the global-norm
    clip's factor), bias-corrected moments ``m / (1 - b1)`` and
    ``v / (1 - b2)``, and decoupled weight decay."""
    w, g = w.double(), g.double() * clip_scale
    m, v = (1 - b1) * g, (1 - b2) * g * g
    step = (m / (1 - b1)) / (torch.sqrt(v / (1 - b2)) + eps)
    return -lr * (step + weight_decay * w)
