"""Gemma3-4B — 5 local : 1 global attention, 128k ctx [hf:google/gemma-3-1b-pt
family card; 4B config].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, window 1024,
rope 10k local / 1M global, qk-norm, geglu.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10_240,
    vocab=262_144,
    window=1024,
    local_per_global=5,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="gelu",
    tied_embeddings=True,
    source="hf:google/gemma-3-1b-pt (family card)",
)
