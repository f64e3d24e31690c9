"""Mamba2: state-space duality (SSD) blocks, arXiv:2405.21060.

The PyTorch counterpart of ``src/repro/models/mamba2.py`` for serving and
training.  Prefill and the training forward run the chunked SSD scan through
:func:`kernels.ssd_scan` (kernel B4 on the card, its plain version on the
CPU; under autograd with the plain backward), and prefill keeps each
layer's final state; decode is the O(1) recurrent update in the activation
dtype, rounded where the JAX package rounds it.  JAX's ``scan`` over stacked
layers becomes a loop over an ``nn.ModuleList``; with ``cfg.remat`` the
training forward recomputes each layer in the backward (``layers.remat``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels.ssd_scan import segsum, ssd_scan
from . import layers as L
from .config import ArchConfig

CONV_WIDTH = 4

__all__ = ["CONV_WIDTH", "Mamba2LM", "causal_conv", "segsum", "ssd_chunked"]


def ssd_chunked(x, a, B, C, chunk: int):
    """SSD scan: x [b,s,h,p], a [b,s,h] (log-decay), B, C [b,s,n] (one
    group).  Returns y [b,s,h,p] and the final state [b,h,p,n] in f32."""
    return ssd_scan(x, a, B.contiguous(), C.contiguous(), chunk)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv, width W: x [B,S,C], w [W,C], b [C]; the sum of
    the W shifted products in the JAX package's order."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return out + b


class Mamba2LM(L.TreeLM):
    """Build with ``Mamba2LM(cfg)``, then give it weights: :meth:`init`
    draws them from a generator, :meth:`load` takes the JAX package's
    parameter tree."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in ("ssm", "hybrid", "hybrid_moe"):
            raise ValueError(f"Mamba2LM serves the ssm family, not {cfg.family}")
        super().__init__(cfg)
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.nheads = cfg.ssm_heads or self.d_inner // 64
        self.headdim = self.d_inner // self.nheads
        self.conv_dim = self.d_inner + 2 * cfg.ssm_state

    # -- params ---------------------------------------------------------------
    def init_layer(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        d, di, n, h = cfg.d_model, self.d_inner, cfg.ssm_state, self.nheads
        dev = generator.device
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "ln": L.init_norm(d, cfg.pdt, dev),
            "in_proj": L.init_linear(d, 2 * di + 2 * n + h, cfg.pdt, generator),
            "conv_w": L._normal((CONV_WIDTH, self.conv_dim), cfg.pdt,
                                1.0 / math.sqrt(CONV_WIDTH), generator),
            "conv_b": torch.zeros((self.conv_dim,), dtype=cfg.pdt, device=dev),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "D": torch.ones((h,), **f32),
            "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, **f32))),
            "norm": L.init_norm(di, cfg.pdt, dev),
            "out_proj": L.init_linear(
                di, d, cfg.pdt, generator,
                scale=1.0 / math.sqrt(di * 2 * cfg.num_layers)),
        }

    def init(self, generator: torch.Generator) -> "Mamba2LM":
        """Fresh weights with the JAX package's scales, drawn on the
        generator's device."""
        cfg = self.cfg
        params = {
            "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, cfg.pdt,
                                      generator),
            "ln_f": L.init_norm(cfg.d_model, cfg.pdt, generator.device),
        }
        layers = [self.init_layer(generator) for _ in range(cfg.num_layers)]
        if not cfg.tie_embeddings:
            params["head"] = L.init_linear(cfg.d_model, cfg.vocab_size,
                                           cfg.pdt, generator)
        return self.load(params, layers)

    # -- block ------------------------------------------------------------------
    # A layer is in_proj (z | x | B C | dt), the depthwise conv and SSD over
    # whole heads (``_scan``, ``_step``), then the gated norm and out_proj.
    # On DTensors the heads shard over ``model`` where it divides them
    # (``_head_placements``): in_proj's z, x and dt columns and out_proj's
    # rows are tensor-parallel, and ``_scan``/``_step`` run per shard of
    # batch and heads (``local_map``), with B and C, which every head
    # shares, replicated.
    def _head_placements(self, x):
        """For a DTensor ``x [B,S,...]``: the placements of the layer's
        per-head activations ``[B,S,C]`` (batch over the data axes, channels
        over ``model`` where it divides the heads), and of B and C."""
        act = L.batch_placements(x.device_mesh, x.shape[0], self.nheads)
        shared = [Replicate() if p.is_shard(2) else p for p in act]
        return act, shared

    def _mix_in(self, lp, x):
        """in_proj and split: z, x, B C (before the conv), dt."""
        di, n, h = self.d_inner, self.cfg.ssm_state, self.nheads
        if not isinstance(x, DTensor):
            z, xBC, dt = torch.split(L.linear(lp["in_proj"], x),
                                     [di, self.conv_dim, h], dim=-1)
            return z, xBC[..., :di], xBC[..., di:], dt
        act, shared = self._head_placements(x)
        return L.linear_split(lp["in_proj"], x, [di, di, 2 * n, h],
                              [act, act, shared, act])

    def _conv_params(self, lp, x):
        """``conv_w``, ``conv_b`` as ``(w_x, b_x, w_BC, b_BC)``."""
        di, n = self.d_inner, self.cfg.ssm_state
        if not isinstance(x, DTensor):
            w, b = lp["conv_w"], lp["conv_b"]
            return w[:, :di], b[:di], w[:, di:], b[di:]
        act, _ = self._head_placements(x)
        heads = [Shard(1) if p.is_shard(2) else Replicate() for p in act]
        rep = [Replicate()] * len(act)
        wx, wbc = L.regroup(lp["conv_w"], [di, 2 * n], 1, [heads, rep])
        bx, bbc = L.regroup(lp["conv_b"], [di, 2 * n], 0,
                            [[Shard(0) if p.is_shard(1) else p for p in heads],
                             rep])
        return wx, bx, wbc, bbc

    def _per_shard(self, fn, x, acts, outs, head_weights, shared_weights):
        """``fn(*acts, *head_weights, *shared_weights)`` on each card's
        shard of batch and heads.  ``acts`` are ``(tensor, role)`` with role
        ``"heads"`` (sharded as the per-head activations, dim 2 of
        ``[B,S,C]``), ``"state"`` (dim 1 of ``[B,h,p,n]``) or ``"shared"``
        (B and C); ``head_weights`` split over heads on their last dim,
        ``shared_weights`` do not.  ``outs`` are the outputs' roles."""
        act, shared = self._head_placements(x)

        def place(role):
            if role == "shared":
                return shared
            if role == "state":
                return [Shard(1) if p.is_shard(2) else p for p in act]
            return act

        def grad(role):
            # B and C feed every head: each card's gradient is its heads'
            # share of the sum
            return ([Partial() if p.is_shard(2) else p for p in act]
                    if role == "shared" else place(role))

        weights = (*head_weights, *shared_weights)
        wpl, wgrad = [], []
        for i, w in enumerate(weights):
            split = i < len(head_weights)
            pl = [Shard(w.dim() - 1) if p.is_shard(2) and split
                  else Replicate() for p in act]
            wpl.append(pl)
            # weights' gradients: partial sums over the batch's mesh dims,
            # and over the heads' where the weight is shared by all heads
            wgrad.append([Partial() if p.is_shard(0) or (
                p.is_shard(2) and not split) else q
                for p, q in zip(act, pl)])
        return local_map(
            fn, out_placements=tuple(place(r) for r in outs),
            in_placements=tuple(place(r) for _, r in acts) + tuple(wpl),
            in_grad_placements=(tuple(grad(r) for _, r in acts)
                                + tuple(wgrad)),
            redistribute_inputs=True)(*(t for t, _ in acts), *weights)

    def _scan(self, xs, bc, dt, wx, bx, dt_bias, A_log, D, wbc, bbc):
        """Conv and SSD over whole heads, plus the skip ``D x``: ``xs``
        ``[B,S,hp]`` (any number of heads), ``bc`` ``[B,S,2n]``, ``dt``
        ``[B,S,h]``; returns ``y [B,S,hp]`` and the final state (f32)."""
        cfg = self.cfg
        Bsz, S, di = xs.shape
        n = cfg.ssm_state
        dtype = xs.dtype
        xBC = F.silu(causal_conv(torch.cat([xs, bc], -1),
                                 torch.cat([wx, wbc], -1).to(dtype),
                                 torch.cat([bx, bbc], -1).to(dtype)))
        xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
        dt = F.softplus(dt.float() + dt_bias)                     # [B,S,h]
        A = -torch.exp(A_log)                                     # [h]
        a = (dt * A).float()                                      # log-decay
        xh = xs.reshape(Bsz, S, -1, self.headdim)
        y, hlast = ssd_chunked(xh * dt.to(dtype)[..., None], a,
                               Bm.to(dtype), Cm.to(dtype), cfg.ssm_chunk)
        y = y + xh * D.to(dtype)[:, None]
        return y.reshape(Bsz, S, di), hlast

    def _gated_out(self, lp, y, z):
        """The gated norm (over all channels: one group) and out_proj."""
        y = L.rms_norm(lp["norm"], y * F.silu(z), self.cfg.norm_eps)
        return L.linear(lp["out_proj"], y)

    def _mix_out(self, lp, x, y, z):
        """The gated norm and out_proj, plus the residual."""
        return x + self._gated_out(lp, y, z)

    def layer(self, lp, x):
        """One layer over a whole sequence ``x [B,S,D]``: returns the output,
        the conv input's last ``CONV_WIDTH - 1`` steps and the SSD's final
        state (f32), which prime the decode cache."""
        out, conv_tail, hlast = self.mixer(lp, x)
        return x + out, conv_tail, hlast

    def mixer(self, lp, x):
        """:meth:`layer` without the residual: the mixer's output
        ``out_proj(norm(y * silu(z)))`` of ``rms_norm(lp["ln"], x)``, the
        conv tail and the final state."""
        cfg = self.cfg
        hin = L.rms_norm(lp["ln"], x, cfg.norm_eps)
        z, xs, bc, dt = self._mix_in(lp, hin)
        # a copy (cat): a view would keep each layer's whole in_proj output
        # alive until prefill stacks the cache
        conv_tail = torch.cat([xs[:, -(CONV_WIDTH - 1):],
                               bc[:, -(CONV_WIDTH - 1):]], -1)
        wx, bx, wbc, bbc = self._conv_params(lp, x)
        hw = (wx, bx, lp["dt_bias"], lp["A_log"], lp["D"])
        if isinstance(x, DTensor):
            y, hlast = self._per_shard(
                self._scan, x, [(xs, "heads"), (bc, "shared"), (dt, "heads")],
                ("heads", "state"), hw, (wbc, bbc))
        else:
            y, hlast = self._scan(xs, bc, dt, *hw, wbc, bbc)
        return self._gated_out(lp, y, z), conv_tail, hlast

    def _step(self, cx, cbc, xs, bc, dt, ssm_st, wx, bx, dt_bias, A_log, D,
              wbc, bbc):
        """The recurrent update for one token over whole heads: conv window
        ``cx [B,W-1,hp]``, ``cbc [B,W-1,2n]``, the token's ``xs [B,1,hp]``,
        ``bc [B,1,2n]``, ``dt [B,1,h]`` and the state ``[B,h,p,n]``.
        Returns ``y [B,1,hp]``, the new windows and the new state."""
        Bsz, _, di = xs.shape
        n = self.cfg.ssm_state
        dtype = xs.dtype
        hist = torch.cat([torch.cat([cx, cbc], -1),
                          torch.cat([xs, bc], -1)], dim=1)        # [B,W,C]
        w = torch.cat([wx, wbc], -1).to(dtype)
        conv_out = (torch.einsum("bwc,wc->bc", hist, w)
                    + torch.cat([bx, bbc], -1).to(dtype))
        xBC1 = F.silu(conv_out)[:, None]
        xs, Bm, Cm = torch.split(xBC1, [di, n, n], dim=-1)
        dtv = F.softplus(dt[:, 0].float() + dt_bias)              # [B,h]
        A = -torch.exp(A_log)
        decay = torch.exp(dtv * A)                                # [B,h]
        xh = xs[:, 0].reshape(Bsz, -1, self.headdim)
        dx = xh * dtv.to(dtype)[..., None]                        # [B,h,p]
        ssm_new = (decay.to(dtype)[..., None, None] * ssm_st
                   + torch.einsum("bhp,bn->bhpn", dx, Bm[:, 0]))
        y = torch.einsum("bhpn,bn->bhp", ssm_new, Cm[:, 0])
        y = (y + xh * D.to(dtype)[:, None]).reshape(Bsz, 1, di)
        return (y, hist[:, 1:, :di].contiguous(),
                hist[:, 1:, di:].contiguous(), ssm_new)

    def decode_layer(self, lp, x, conv_st, ssm_st):
        """One layer for one token ``x [B,1,D]``: the recurrent update in the
        activation dtype.  Returns the output, the new conv window and the
        new state."""
        cfg = self.cfg
        di, n = self.d_inner, cfg.ssm_state
        hin = L.rms_norm(lp["ln"], x, cfg.norm_eps)
        z, xs, bc, dt = self._mix_in(lp, hin)                     # [B,1,*]
        wx, bx, wbc, bbc = self._conv_params(lp, x)
        hw = (wx, bx, lp["dt_bias"], lp["A_log"], lp["D"])
        if isinstance(x, DTensor):
            act, shared = self._head_placements(x)
            cx, cbc = L.regroup(conv_st, [di, 2 * n], -1, [act, shared])
            y, nx, nbc, ssm_new = self._per_shard(
                self._step, x,
                [(cx, "heads"), (cbc, "shared"), (xs, "heads"),
                 (bc, "shared"), (dt, "heads"), (ssm_st, "state")],
                ("heads", "heads", "shared", "state"), hw, (wbc, bbc))
        else:
            y, nx, nbc, ssm_new = self._step(
                conv_st[..., :di], conv_st[..., di:], xs, bc, dt, ssm_st,
                *hw, wbc, bbc)
        out = self._mix_out(lp, x, y, z)
        return out, torch.cat([nx, nbc], -1), ssm_new

    # -- forward ------------------------------------------------------------------
    def forward(self, ids):
        x = L.embed(self.params["embed"], ids).to(self.cfg.adt)
        for lp in self.layers:
            x = L.remat(self.cfg, self.layer, lp, x)[0]
        return self._logits(x), 0.0

    # -- decode (recurrent; O(1) in sequence length) ---------------------------------
    def init_cache(self, B: int, max_len: int, device=None) -> dict:
        """``pos`` is a Python int; ``max_len`` does not size the state."""
        cfg = self.cfg
        Lr, h, p, n = cfg.num_layers, self.nheads, self.headdim, cfg.ssm_state
        return {
            "conv": torch.zeros((Lr, B, CONV_WIDTH - 1, self.conv_dim),
                                dtype=cfg.adt, device=device),
            "ssm": torch.zeros((Lr, B, h, p, n), dtype=cfg.adt, device=device),
            "pos": 0,
        }

    def prefill(self, ids, max_len: int):
        """Run the full prompt, return (last-token logits, primed cache)."""
        cfg = self.cfg
        x = L.embed(self.params["embed"], ids).to(cfg.adt)
        convs, ssms = [], []
        for lp in self.layers:
            x, conv_tail, hlast = self.layer(lp, x)
            convs.append(conv_tail)
            ssms.append(hlast)
        cache = {"conv": torch.stack(convs).to(cfg.adt),
                 "ssm": torch.stack(ssms).to(cfg.adt), "pos": ids.shape[1]}
        return self._logits(x[:, -1:])[:, -1], cache

    def decode_step(self, cache, ids):
        """ids: [B,1] next token; returns (logits [B,V], new cache).

        Unlike the JAX version, the new conv window and state are written
        into the cache's ``conv`` and ``ssm`` tensors in place (the returned
        cache shares them)."""
        x = L.embed(self.params["embed"], ids).to(self.cfg.adt)   # [B,1,D]
        for i, lp in enumerate(self.layers):
            x, conv_new, ssm_new = self.decode_layer(
                lp, x, cache["conv"][i], cache["ssm"][i])
            cache["conv"][i] = conv_new
            cache["ssm"][i] = ssm_new
        return self._logits(x)[:, 0], {"conv": cache["conv"],
                                        "ssm": cache["ssm"],
                                        "pos": cache["pos"] + 1}
