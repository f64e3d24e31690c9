# Copied from src/repro/models/config.py; pdt and adt return torch dtypes.
"""Unified architecture config covering all assigned families."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int                # GQA kv heads
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    # attention details
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp: str = "swiglu"              # swiglu | gelu
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0               # mamba2 value heads
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_every: int = 0              # zamba2: shared attn block period
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500           # stub frontend output length
    # vlm (internvl)
    vis_tokens: int = 256            # stub patch embeddings per image
    # numerics
    param_dtype: str = "float32"
    dtype: str = "bfloat16"          # activation/compute dtype
    remat: bool = True
    scan_layers: bool = True
    # perf knobs (§Perf hillclimbs; defaults = paper-faithful baseline)
    flash_attention: bool = False    # fused blockwise attention everywhere
    moe_group: int = 512             # MoE dispatch group size
    ablate_attention: bool = False   # measurement-only: zero out attention
                                     # mixing to isolate non-attention traffic

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized config of the same family (see spec §f)."""
        small = dict(
            num_layers=min(self.num_layers, 2 if self.attn_every == 0 else 4),
            d_model=128,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.num_heads else None,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=32,
            vis_tokens=16,
            sliding_window=64 if self.sliding_window else None,
            param_dtype="float32",
            dtype="float32",
        )
        small.update(overrides)
        return replace(self, **small)

    # -- parameter count (for 6ND model-flops accounting) --------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts top-k experts."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                        # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            hd, H, K = self.hd, self.num_heads, self.num_kv_heads
            attn = d * H * hd + 2 * d * K * hd + H * hd * d
            if self.family == "moe":
                e = self.top_k if active_only else self.num_experts
                mlp = e * 3 * d * self.d_ff
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                mlp = mult * d * self.d_ff
            per_layer = attn + mlp + 2 * d
            n += L * per_layer
            if self.family == "audio":
                n += self.enc_layers * (attn + mlp + 2 * d) + L * attn  # cross
        elif self.family == "ssm":
            di = self.ssm_expand * d
            per_layer = d * (2 * di + 2 * self.ssm_state) + di * d + 2 * d
            n += L * per_layer
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            ssm_l = d * (2 * di + 2 * self.ssm_state) + di * d + 2 * d
            hd, H, K = self.hd, self.num_heads, self.num_kv_heads
            attn = d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * self.d_ff
            n += L * ssm_l + attn   # shared attn block counted once
        return n


@dataclass(frozen=True)
class HybridMoEConfig(ArchConfig):
    """The ``hybrid_moe`` family (granite-4.0-h, ``granitemoehybrid``): each
    layer's mixer is Mamba2 or attention as ``layer_types`` names it, with
    weights of its own, and every layer ends in a routed MoE of
    ``num_experts`` experts of width ``d_ff`` (top ``top_k``) beside a
    shared SwiGLU expert of width ``shared_ff``.  The muP multipliers scale
    the embedding, both residual branches and (dividing) the logits;
    ``attention_multiplier`` is the softmax scale (None: ``1/sqrt(hd)``).

    ``experts_held`` of the router's ``num_experts`` are held here (0: all),
    the experts ``expert_rank * experts_held`` on: one card's share of an
    expert-parallel group.  A separate class, so that ``ArchConfig`` keeps
    the JAX package's fields."""
    layer_types: tuple = ()
    attention_multiplier: Optional[float] = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    shared_ff: int = 0
    experts_held: int = 0
    expert_rank: int = 0

    @property
    def held(self) -> range:
        """The router outputs whose experts are held here."""
        n = self.experts_held or self.num_experts
        return range(self.expert_rank * n, (self.expert_rank + 1) * n)

    def reduced(self, **overrides) -> "HybridMoEConfig":
        """A smoke-test-sized config with the published pattern's attention
        layer among Mamba2 layers (``layer_types[3:7]``)."""
        small = dict(
            num_layers=4, layer_types=tuple(self.layer_types[3:7]),
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
            shared_ff=48, vocab_size=256, num_experts=8, top_k=3,
            experts_held=2, expert_rank=0, ssm_state=16, ssm_heads=4,
            ssm_chunk=16, attention_multiplier=1.0 / 16,
            param_dtype="float32", dtype="float32",
        )
        small.update(overrides)
        return replace(self, **small)

    def param_count(self, active_only: bool = False) -> int:
        """Every parameter held here (the embedding is tied); with
        ``active_only`` the held experts count by the share of them a token
        uses on average, ``top_k * experts_held / num_experts``."""
        d, V, E = self.d_model, self.vocab_size, self.num_experts
        di, n = self.ssm_expand * d, self.ssm_state
        h = self.ssm_heads or di // 64
        hd, H, K = self.hd, self.num_heads, self.num_kv_heads
        experts = 3 * d * self.d_ff * len(self.held)
        if active_only:
            experts = experts * self.top_k // E
        ffn = d + d * E + experts + 3 * d * self.shared_ff     # ln2 .. shared
        # norm, in_proj, conv (width 4) and bias, A_log, D, dt_bias, gated
        # norm, out_proj
        mamba = (d + d * (2 * di + 2 * n + h) + 5 * (di + 2 * n) + 3 * h
                 + di + di * d)
        attn = d + d * H * hd + 2 * d * K * hd + H * hd * d
        kinds = {"mamba": mamba, "attention": attn}
        return V * d + d + sum(kinds[t] + ffn for t in self.layer_types)
