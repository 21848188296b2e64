"""Snowflake Arctic 480B — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2,
dense FFN residual in parallel with the MoE in every layer.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab=32_000,
    rope_theta=10_000.0,
    tied_embeddings=False,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
    capacity_factor=1.25,
    source="hf:Snowflake/snowflake-arctic-base",
)
