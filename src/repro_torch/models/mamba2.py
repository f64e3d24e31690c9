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
        if cfg.family not in ("ssm", "hybrid"):
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
    def _mix_in(self, lp, x):
        """in_proj and split: z, xBC (before the conv), dt."""
        zxbcdt = L.linear(lp["in_proj"], x)
        return torch.split(zxbcdt, [self.d_inner, self.conv_dim, self.nheads],
                           dim=-1)

    def _mix_out(self, lp, x, xh, y, z):
        """The skip term ``D x``, the gated norm and out_proj, plus the
        residual."""
        cfg = self.cfg
        Bsz, S = x.shape[:2]
        y = y + xh * lp["D"].to(x.dtype)[:, None]
        y = y.reshape(Bsz, S, self.d_inner)
        y = L.rms_norm(lp["norm"], y * F.silu(z), cfg.norm_eps)
        return x + L.linear(lp["out_proj"], y)

    def layer(self, lp, x):
        """One layer over a whole sequence ``x [B,S,D]``: returns the output,
        the conv input's last ``CONV_WIDTH - 1`` steps and the SSD's final
        state (f32), which prime the decode cache."""
        cfg = self.cfg
        Bsz, S, _ = x.shape
        di, n, h = self.d_inner, cfg.ssm_state, self.nheads
        hin = L.rms_norm(lp["ln"], x, cfg.norm_eps)
        z, xBC, dt = self._mix_in(lp, hin)
        # a copy: a view would keep each layer's whole in_proj output alive
        # until prefill stacks the cache
        conv_tail = xBC[:, -(CONV_WIDTH - 1):, :].clone()
        xBC = F.silu(causal_conv(xBC, lp["conv_w"].to(x.dtype),
                                 lp["conv_b"].to(x.dtype)))
        xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
        dt = F.softplus(dt.float() + lp["dt_bias"])               # [B,S,h]
        A = -torch.exp(lp["A_log"])                               # [h]
        a = (dt * A).float()                                      # log-decay
        xh = xs.reshape(Bsz, S, h, self.headdim)
        y, hlast = ssd_chunked(xh * dt.to(x.dtype)[..., None], a,
                               Bm.to(x.dtype), Cm.to(x.dtype), cfg.ssm_chunk)
        return self._mix_out(lp, x, xh, y, z), conv_tail, hlast

    def decode_layer(self, lp, x, conv_st, ssm_st):
        """One layer for one token ``x [B,1,D]``: the recurrent update in the
        activation dtype.  Returns the output, the new conv window and the
        new state."""
        cfg = self.cfg
        B = x.shape[0]
        di, n, h = self.d_inner, cfg.ssm_state, self.nheads
        hin = L.rms_norm(lp["ln"], x, cfg.norm_eps)
        z, xBC, dt = self._mix_in(lp, hin)                        # [B,1,*]
        hist = torch.cat([conv_st, xBC], dim=1)                   # [B,W,convdim]
        w = lp["conv_w"].to(x.dtype)
        conv_out = torch.einsum("bwc,wc->bc", hist, w) + lp["conv_b"].to(x.dtype)
        xBC1 = F.silu(conv_out)[:, None]
        xs, Bm, Cm = torch.split(xBC1, [di, n, n], dim=-1)
        dtv = F.softplus(dt[:, 0].float() + lp["dt_bias"])        # [B,h]
        A = -torch.exp(lp["A_log"])
        decay = torch.exp(dtv * A)                                # [B,h]
        xh = xs[:, 0].reshape(B, h, self.headdim)
        dx = xh * dtv.to(x.dtype)[..., None]                      # [B,h,p]
        ssm_new = (decay.to(x.dtype)[..., None, None] * ssm_st
                   + torch.einsum("bhp,bn->bhpn", dx, Bm[:, 0]))
        y = torch.einsum("bhpn,bn->bhp", ssm_new, Cm[:, 0])
        out = self._mix_out(lp, x, xh[:, None], y[:, None], z)
        return out, hist[:, 1:], ssm_new

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
