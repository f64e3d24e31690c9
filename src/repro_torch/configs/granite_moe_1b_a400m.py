# Copied from src/repro/configs/granite_moe_1b_a400m.py, with imports from repro_torch.
"""Granite-3.0-1B-A400M — MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, top_k=8,
    rope_theta=1e4, mlp="swiglu", tie_embeddings=True,
)
