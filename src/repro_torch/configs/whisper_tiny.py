# Copied from src/repro/configs/whisper_tiny.py, with imports from repro_torch.
"""Whisper-tiny — enc-dec backbone; conv/mel frontend is a stub
(precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    enc_layers=4, enc_frames=1500,
    rope_theta=0.0, mlp="gelu", tie_embeddings=True,
)
