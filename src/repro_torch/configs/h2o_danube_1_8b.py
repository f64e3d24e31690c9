# Copied from src/repro/configs/h2o_danube_1_8b.py, with imports from repro_torch.
"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    rope_theta=1e4, mlp="swiglu", sliding_window=4096,
)
