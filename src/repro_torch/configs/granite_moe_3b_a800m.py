# Copied from src/repro/configs/granite_moe_3b_a800m.py, with imports from repro_torch.
"""Granite-3.0-3B-A800M — MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8,
    rope_theta=1e4, mlp="swiglu", tie_embeddings=True,
)
