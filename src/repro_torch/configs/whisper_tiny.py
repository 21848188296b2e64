"""Whisper-tiny — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

4L (decoder) + 4L encoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865;
audio frontend is a stub: input_specs provide precomputed frame embeddings
(1500 x 384).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51_865,
    act="gelu",
    tied_embeddings=True,
    encoder_layers=4,
    audio_frames=1500,
    source="arXiv:2212.04356",
)
