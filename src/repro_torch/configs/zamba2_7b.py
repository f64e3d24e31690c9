# Copied from src/repro/configs/zamba2_7b.py, with imports from repro_torch.
"""Zamba2-7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  81 SSM layers; the shared full-attention block is
invoked every ``attn_every`` layers (81 = 27 groups x 3)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_chunk=64, attn_every=3,
    rope_theta=1e4, mlp="swiglu",
)
