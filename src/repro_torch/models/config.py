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
