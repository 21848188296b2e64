"""Llama-3.2-Vision-90B — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, 90B scaling].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; 20 cross-attn
layers (1 per 4 self layers); vision frontend stubbed (precomputed patch
embeddings, 1601 tokens x 1280).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28_672,
    vocab=128_256,
    rope_theta=500_000.0,
    tied_embeddings=False,
    cross_attn_every=4,
    vision_tokens=1601,
    vision_dim=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
