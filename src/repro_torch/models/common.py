"""Model configuration and shared building blocks (norms, MLPs, embeddings).

The counterpart of ``repro.models.common``. Parameters are nested dicts
of tensors, every module an ``init`` plus a pure ``apply``; the
initializers draw the reference's distributions from a seeded
``torch.Generator`` (the numbers differ from JAX's threefry draws, so
tests carry the reference's parameters across with
``repro_torch.interop.lm_params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every architecture family in the zoo."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None  # default d_model // n_heads

    # attention
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None  # gemma3 global layers use 1e6
    window: int | None = None  # sliding-window size for local layers
    global_every: int | None = None
    local_per_global: int | None = None  # gemma3: 5 local then 1 global
    qkv_bias: bool = False  # qwen1.5
    qk_norm: bool = False  # gemma3
    act: str = "silu"  # silu (swiglu) | gelu (geglu)
    tied_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    first_k_dense: int = 0
    moe_dense_residual: bool = False

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): layer pattern within a super-block
    block_pattern: tuple = ()
    rglru_conv: int = 4

    # VLM
    cross_attn_every: int = 0
    vision_tokens: int = 0
    vision_dim: int = 0

    # audio (whisper): encoder spec; n_layers is the decoder depth
    encoder_layers: int = 0
    audio_frames: int = 0

    # numerics / memory
    dtype: Any = torch.bfloat16  # activations
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    logits_chunk: int = 0
    cache_mode: str = "uniform"  # uniform | rightsized (local layers)

    # source citation (model card / paper)
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts (the
        reference's overrides, in float32)."""
        base = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
            remat=False,
            dtype=torch.float32,
            param_dtype=torch.float32,
        )
        if self.n_experts:
            base.update(
                n_experts=4,
                top_k=min(self.top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.ssm_state:
            base.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
        if self.window:
            base.update(window=min(self.window, 32))
        if self.local_per_global:
            base.update(local_per_global=min(self.local_per_global, 2))
        if self.cross_attn_every:
            base.update(cross_attn_every=2, vision_tokens=16, vision_dim=64,
                        n_layers=3)
        if self.encoder_layers:
            base.update(encoder_layers=2, audio_frames=32)
        if self.block_pattern:
            base.update(window=min(self.window or 32, 32), n_layers=3)
        base.update(overrides)
        return dataclasses.replace(self, **base)


# ---------------------------------------------------------------------------
# initializers: the reference's distributions, drawn from ``gen``
# (parameters land on the generator's device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, fan_in: int, dtype, *,
               scale: float = 1.0) -> torch.Tensor:
    """Standard normal truncated at +-2, times scale / sqrt(fan_in),
    drawn in float32 and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(scale / fan_in**0.5).to(dtype)


def residual_out_init(gen: torch.Generator, shape, fan_in: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """GPT-2-style scaled init for projections feeding the residual
    stream: scale 1/sqrt(2 L)."""
    scale = 1.0 / (2.0 * max(cfg.n_layers, 1)) ** 0.5
    return dense_init(gen, shape, fan_in, cfg.param_dtype, scale=scale)


def rmsnorm_init(shape, cfg: ModelConfig, device) -> dict:
    """Norm scales are stored as 0 and applied as ``1 + scale``."""
    return {"scale": torch.zeros(shape, dtype=cfg.param_dtype, device=device)}


def mlp_init(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """Gated-MLP weights; ``lead`` prepends stacking axes (layers)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (*lead, d, f), d, cfg.param_dtype),
        "w_up": dense_init(gen, (*lead, d, f), d, cfg.param_dtype),
        "w_down": residual_out_init(gen, (*lead, f, d), f, cfg),
    }


def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=gen.device)
    return {"table": (emb * cfg.d_model**-0.5).to(cfg.param_dtype)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].float())).to(x.dtype)


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU). x: (..., d_model). ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    return (act * up) @ params["w_down"]


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Row gather, cast to ``cfg.dtype``; dense-like families scale by
    sqrt(d_model) with the scalar rounded to ``cfg.dtype`` first."""
    x = params["table"][tokens].to(cfg.dtype)
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype)
    return x


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits x @ table.T for a (vocab, d_model) table."""
    return x @ table.T.to(x.dtype)


# ---------------------------------------------------------------------------
# cross-entropy (training loss)
# ---------------------------------------------------------------------------

def _masked_mean(nll: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean next-token CE in float32. logits (B, T, V), labels (B, T);
    ``mask`` (B, T) weights each position (its sum, at least 1, divides)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _masked_mean(logz - gold, mask)


def lm_cross_entropy(feats: torch.Tensor, table: torch.Tensor,
                     labels: torch.Tensor, mask=None) -> torch.Tensor:
    """CE from features (B, T, D) and a (vocab, D) table: the logsumexp
    of the logits ``feats @ table.T`` (in the features' dtype) taken in
    float32, and the gold logit as <feats, table[labels]> in float32, a
    row gather instead of a gather from the (B, T, V) logits."""
    logits = feats @ table.T.to(feats.dtype)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold_rows = table[labels.long()].float()  # (B, T, D)
    gold = torch.einsum("btd,btd->bt", feats.float(), gold_rows)
    return _masked_mean(logz - gold, mask)


def chunked_cross_entropy(features: torch.Tensor, emb_table: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          mask=None) -> torch.Tensor:
    """CE over T in chunks of ``chunk`` positions, each chunk's (B, c, V)
    logits at a time (the reference's ``lax.scan``, in its order): the
    masked sum of the chunks' nll over the masked count, at least 1."""
    b, t, d = features.shape
    if t % chunk != 0:
        raise ValueError(f"sequence length {t} must be divisible by the "
                         f"cross-entropy chunk {chunk}")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    mask = mask.float()
    table = emb_table.T.to(features.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=features.device)
    cnt = torch.zeros((), dtype=torch.float32, device=features.device)
    for c0 in range(0, t, chunk):
        f = features[:, c0:c0 + chunk]
        lab = labels[:, c0:c0 + chunk]
        mk = mask[:, c0:c0 + chunk]
        logits = (f @ table).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        tot = tot + torch.sum((logz - gold) * mk)
        cnt = cnt + torch.sum(mk)
    return tot / torch.clamp(cnt, min=1.0)
