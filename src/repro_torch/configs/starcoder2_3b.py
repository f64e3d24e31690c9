# Copied from src/repro/configs/starcoder2_3b.py, with imports from repro_torch.
"""StarCoder2-3B — dense, GQA(kv=2), RoPE [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    rope_theta=1e5, mlp="gelu", qkv_bias=True,
)
