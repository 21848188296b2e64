"""Mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    tied_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    source="arXiv:2405.21060",
)
