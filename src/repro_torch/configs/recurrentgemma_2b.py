"""RecurrentGemma-2B — RG-LRU + local attention, 2 recurrent : 1 attn
[arXiv:2402.19427 (Griffin)].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window 2048.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256_000,
    window=2048,
    rope_theta=10_000.0,
    act="gelu",
    tied_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    rglru_conv=4,
    source="arXiv:2402.19427",
)
