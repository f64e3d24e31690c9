# Copied from src/repro/configs/internvl2_26b.py, with imports from repro_torch.
"""InternVL2-26B — InternViT (stub: precomputed patch embeddings) +
InternLM2-20B language backbone [arXiv:2404.16821; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    vis_tokens=256, rope_theta=1e6, mlp="swiglu",
)
