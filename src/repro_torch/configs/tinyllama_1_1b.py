"""TinyLlama-1.1B — llama2-arch small [arXiv:2401.02385].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32_000,
    rope_theta=10_000.0,
    tied_embeddings=False,
    source="arXiv:2401.02385",
)
