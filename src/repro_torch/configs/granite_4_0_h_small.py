"""Granite-4.0-H-Small (32B-A9B) — 40 layers, Mamba2 and NoPE GQA
attention (36:4, attention at 5, 15, 25, 35), each followed by a 72-expert
top-10 MoE beside a shared expert; muP multipliers
[hf:ibm-granite/granite-4.0-h-small, config.json].

As published but for ``ssm_chunk``: kernel B4 blocks the SSD in chunks of
64 (its limit), where the published ``mamba_chunk_size`` is 256; the scan's
result does not depend on the chunk."""
from repro_torch.models.config import HybridMoEConfig

LAYER_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba"
                    for i in range(40))

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=768, vocab_size=100352,
    num_experts=72, top_k=10, shared_ff=1536,
    ssm_state=128, ssm_heads=128, ssm_expand=2, ssm_chunk=64,
    rope_theta=0.0, tie_embeddings=True, norm_eps=1e-5, mlp="swiglu",
    flash_attention=True, layer_types=LAYER_TYPES,
    attention_multiplier=0.0078125, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
)
