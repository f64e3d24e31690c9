# Copied from src/repro/configs/qwen2_1_5b.py, with imports from repro_torch.
"""Qwen2-1.5B — dense GQA(kv=2) with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    rope_theta=1e6, mlp="swiglu", qkv_bias=True, tie_embeddings=True,
)
