"""Gemma3-1B — 5 local : 1 global, 128k [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, window 512.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab=262_144,
    window=512,
    local_per_global=5,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="gelu",
    tied_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
