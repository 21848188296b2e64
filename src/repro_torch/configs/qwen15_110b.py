"""Qwen1.5-110B — QKV bias [hf:Qwen/Qwen1.5-0.5B family card, 110B config].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49_152,
    vocab=152_064,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tied_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B (family card)",
)
