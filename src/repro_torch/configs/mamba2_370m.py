# Copied from src/repro/configs/mamba2_370m.py, with imports from repro_torch.
"""Mamba2-370M — pure SSM with state-space duality
[arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_chunk=64,
    rope_theta=0.0, tie_embeddings=True,
)
