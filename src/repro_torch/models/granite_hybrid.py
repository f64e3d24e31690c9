"""Granite-4.0-H (``granitemoehybrid``): Mamba2 and attention layers
interleaved as ``cfg.layer_types`` names them, each with weights of its own,
and every layer ending in a dropless routed MoE beside a shared SwiGLU
expert; muP multipliers on the embedding, the residual branches and the
logits.  Per layer, with ``r = cfg.residual_multiplier``::

    h  = x + r * mixer(x)          Mamba2: Mamba2LM.mixer (its own input norm)
                                   attention: attn(RMSNorm(x)), no rotary,
                                   softmax scale cfg.attention_multiplier
    x' = h + r * (moe(u) + shared(u)),   u = RMSNorm(h)

``x0 = cfg.embedding_multiplier * E[ids]``, logits ``RMSNorm(x_L) E^T /
cfg.logits_scaling`` (tied embedding).  The MoE is
``layers.moe_dropless`` over ``cfg.held``, the experts this card holds of
the router's ``cfg.num_experts``: the router keeps every output and its
top-k, and the part of the experts held elsewhere is left out.  No
auxiliary balancing loss.

Training runs through ``runtime.TrainLoop`` as every family does: the
Mamba2 layers' SSD through kernel B4 and the attention through kernel B3
(``cfg.flash_attention``) on the card, their plain versions on the CPU,
and with ``cfg.remat`` each layer recomputed in the backward.  Each part
of a layer runs under a ``torch.profiler.record_function`` range
(``granite.mamba``, ``granite.attention``, ``granite.moe``).  There is no
decode cache: the family trains and runs whole sequences.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from . import layers as L
from .config import HybridMoEConfig
from .mamba2 import Mamba2LM


class GraniteHybridLM(L.TreeLM):
    """Build with ``GraniteHybridLM(cfg)``, then :meth:`init` or
    :meth:`load`.  A Mamba2 layer's tree is ``{"mamba", "ln2", "moe",
    "shared"}`` (``mamba`` as a ``Mamba2LM`` layer, input norm included), an
    attention layer's ``{"ln1", "attn", "ln2", "moe", "shared"}``."""

    def __init__(self, cfg: HybridMoEConfig):
        if cfg.family != "hybrid_moe":
            raise ValueError(f"GraniteHybridLM serves the hybrid_moe family, "
                             f"not {cfg.family}")
        if len(cfg.layer_types) != cfg.num_layers or not set(
                cfg.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"layer_types {cfg.layer_types} must name "
                             f"'mamba' or 'attention' for each of "
                             f"{cfg.num_layers} layers")
        if cfg.held.stop > cfg.num_experts:
            raise ValueError(f"experts {cfg.held} exceed the router's "
                             f"{cfg.num_experts}")
        super().__init__(cfg)
        self.mamba = Mamba2LM(cfg)          # the Mamba2 blocks; no weights

    # -- params ---------------------------------------------------------------
    def init_layer(self, kind: str, generator: torch.Generator) -> dict:
        cfg = self.cfg
        d, F_, n = cfg.d_model, cfg.d_ff, len(cfg.held)
        dev = generator.device
        if kind == "mamba":
            p = {"mamba": self.mamba.init_layer(generator)}
        else:
            p = {"ln1": L.init_norm(d, cfg.pdt, dev),
                 "attn": L.init_attention(cfg, generator)}
        s_out = 1.0 / math.sqrt(F_ * 2 * cfg.num_layers)
        p["ln2"] = L.init_norm(d, cfg.pdt, dev)
        p["moe"] = {
            "router": L.init_linear(d, cfg.num_experts, torch.float32,
                                    generator),
            "wg": L._normal((n, d, F_), cfg.pdt, 1.0 / math.sqrt(d), generator),
            "wi": L._normal((n, d, F_), cfg.pdt, 1.0 / math.sqrt(d), generator),
            "wo": L._normal((n, F_, d), cfg.pdt, s_out, generator),
        }
        p["shared"] = L.init_mlp(cfg, generator, d_ff=cfg.shared_ff)
        return p

    def init(self, generator: torch.Generator) -> "GraniteHybridLM":
        """Fresh weights, drawn on the generator's device."""
        cfg = self.cfg
        params = {
            "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, cfg.pdt,
                                      generator),
            "ln_f": L.init_norm(cfg.d_model, cfg.pdt, generator.device),
        }
        layers = [self.init_layer(kind, generator) for kind in cfg.layer_types]
        return self.load(params, layers)

    # -- layers ---------------------------------------------------------------
    def _ffn(self, lp, h, layer: int):
        """``h + r * (moe(u) + shared(u))``, ``u = RMSNorm(h)``."""
        cfg = self.cfg
        with record_function("granite.moe"):
            u = L.rms_norm(lp["ln2"], h, cfg.norm_eps)
            y = L.moe_dropless(lp["moe"], u, top_k=cfg.top_k, held=cfg.held,
                               layer=layer) + L.mlp(lp["shared"], cfg, u)
        return h + cfg.residual_multiplier * y

    def _layer(self, lp, x, kind: str, layer: int, positions, mask):
        cfg = self.cfg
        if kind == "mamba":
            with record_function("granite.mamba"):
                out = self.mamba.mixer(lp["mamba"], x)[0]
        else:
            with record_function("granite.attention"):
                out, _ = L.attention(lp["attn"], cfg,
                                     L.rms_norm(lp["ln1"], x, cfg.norm_eps),
                                     positions, mask,
                                     use_kernel=cfg.flash_attention,
                                     causal=True,
                                     scale=cfg.attention_multiplier)
        return self._ffn(lp, x + cfg.residual_multiplier * out, layer)

    # -- forward --------------------------------------------------------------
    def forward(self, ids):
        cfg = self.cfg
        S = ids.shape[1]
        x = (L.embed(self.params["embed"], ids)
             * cfg.embedding_multiplier).to(cfg.adt)
        positions = torch.arange(S, device=ids.device)
        mask = L.causal_mask(S, S, device=ids.device)
        for i, (lp, kind) in enumerate(zip(self.layers, cfg.layer_types)):
            x = L.remat(cfg, self._layer, lp, x, kind, i, positions, mask)
        return self._logits(x) / cfg.logits_scaling, 0.0
