# Copied from src/repro/configs/minitron_4b.py, with imports from repro_torch.
"""Minitron-4B — pruned Nemotron, dense GQA(kv=8), 256k vocab
[arXiv:2407.14679; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    rope_theta=1e4, mlp="swiglu", head_dim=128, tie_embeddings=True,
)
