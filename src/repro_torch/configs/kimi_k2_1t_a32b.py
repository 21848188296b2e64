"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8, 1 shared expert, first layer dense.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=16384,  # first dense layer / dense-equivalent width (8 active experts)
    vocab=163_840,
    rope_theta=50_000.0,
    tied_embeddings=False,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    first_k_dense=1,
    capacity_factor=1.25,
    source="arXiv:2501.kimi2 (Kimi K2 model table)",
)
