"""Frozen work of one training step of a granite-4.0-h share, from the
configuration file's keys (``config.json``'s names), and the card's bf16
peak (``tensor_peaks.json``).

Parameters held here: the tied embedding's rows and the final norm; per
Mamba2 layer its norm, ``in_proj`` (``z``, ``x``, ``B``, ``C``, ``dt``),
the depthwise conv (weights and bias), ``A_log``, ``D``, ``dt_bias``, the
gated norm and ``out_proj``; per attention layer its norm and the ``q``,
``k``, ``v``, ``o`` projections (no bias); per layer the second norm, the
router (every expert's logit), the held experts and the shared expert,
each three products of the hidden size by its width.

Active parameters count the held experts by the share a token uses on
average, ``top_k / router_experts`` of them.  A step's operations, as
PaLM's accounting: ``6`` per active parameter per token (forward and
backward), plus ``12 S d_attn`` per token for each attention layer (the
logits and the weighted sum over the whole ``S x S``, forward and
backward; not halved for the causal mask).
"""

import json
from pathlib import Path


def bf16_peak() -> float:
    """The dense bf16 rate of the card, operations per second."""
    path = Path(__file__).with_name("tensor_peaks.json")
    return float(json.loads(path.read_text())["bf16_flops_per_s"])


def held_params(cfg: dict, active_only: bool = False) -> int:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    di = cfg["mamba_n_heads"] * cfg["mamba_d_head"]
    n, h, W = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_conv"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    experts = 3 * d * cfg["intermediate_size"] * cfg["num_local_experts"]
    if active_only:
        experts = experts * k // E
    ffn = d + d * E + experts + 3 * d * cfg["shared_intermediate_size"]
    mamba = (d + d * (2 * di + 2 * n + h) + (W + 1) * (di + 2 * n) + 3 * h
             + di + di * d)
    attn = d + d * H * hd + 2 * d * K * hd + H * hd * d
    per = {"mamba": mamba, "attention": attn}
    return V * d + d + sum(per[t] + ffn for t in cfg["layer_types"])


def step_flops(cfg: dict, batch: int, seq_len: int) -> int:
    """Operations of one training step of ``batch`` sequences of
    ``seq_len`` tokens."""
    tokens = batch * seq_len
    d_attn = cfg["num_attention_heads"] * (cfg["hidden_size"]
                                          // cfg["num_attention_heads"])
    attn_layers = sum(t == "attention" for t in cfg["layer_types"])
    return (6 * held_params(cfg, active_only=True) * tokens
            + 12 * seq_len * d_attn * tokens * attn_layers)
