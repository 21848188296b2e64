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

from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.ctx import get_mesh


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


# the leaves the reference keeps in float32 whatever ``param_dtype`` is:
# mamba2's decay logs, skip and step bias (``ssd.py``) and the RG-LRU's
# Lambda (``rglru.py``)
FLOAT32_LEAVES = ("a_log", "d_skip", "dt_bias", "lam")


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


def stacked_dense_init(gen: torch.Generator, shape, fan_in: int, dtype, *,
                       scale: float = 1.0) -> torch.Tensor:
    """``dense_init``'s distribution for a stack of (d_in, d_out)
    matrices (experts, layers), drawn one matrix at a time in float32
    and written into a tensor of ``dtype``: no float32 copy of the whole
    stack exists (arctic's (2, 128, 7168, 4864) expert stack is 17.8 GB
    in bfloat16, and its float32 draw would be 35.7 GB more)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    buf = torch.empty(shape[-2:], dtype=torch.float32, device=gen.device)
    for matrix in out.view(-1, *shape[-2:]):
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
        matrix.copy_(buf.mul_(scale / fan_in**0.5))
    return out


def residual_scale(cfg: ModelConfig) -> float:
    """GPT-2-style scale of projections feeding the residual stream:
    1/sqrt(2 L)."""
    return 1.0 / (2.0 * max(cfg.n_layers, 1)) ** 0.5


def residual_out_init(gen: torch.Generator, shape, fan_in: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """``dense_init`` at ``residual_scale``, for projections feeding the
    residual stream."""
    return dense_init(gen, shape, fan_in, cfg.param_dtype,
                      scale=residual_scale(cfg))


def rmsnorm_init(shape, cfg: ModelConfig, device) -> dict:
    """Norm scales are stored as 0 and applied as ``1 + scale``."""
    return {"scale": torch.zeros(shape, dtype=cfg.param_dtype, device=device)}


def mlp_init(gen: torch.Generator, cfg: ModelConfig, lead=(),
             d_ff: "int | None" = None) -> dict:
    """Gated-MLP weights of width ``d_ff`` (default ``cfg.d_ff``; a MoE's
    shared expert passes its own); ``lead`` prepends stacking axes
    (layers)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
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


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              d_ff: "int | None" = None) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU). x: (..., d_model). ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this.

    On a mesh, weights narrower than the MLP's width ``d_ff`` (default
    ``cfg.d_ff``) are this rank's ``model`` block of it: ``w_gate`` and
    ``w_up`` column-parallel, ``w_down`` row-parallel, its partial output
    summed over ``model`` (x's cotangent too, in the backward)."""
    mesh = get_mesh()
    model = (tp.layout(mesh).model if mesh is not None
             and params["w_gate"].shape[-1] != (d_ff or cfg.d_ff) else None)
    x = tp.replicated_input(x, model)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    return tp.sum_over((act * up) @ params["w_down"], model)


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Row gather, cast to ``cfg.dtype``; dense-like families scale by
    sqrt(d_model) with the scalar rounded to ``cfg.dtype`` first.

    On a mesh, a table of fewer than ``cfg.vocab`` rows is this rank's
    ``model`` block of the vocab: the rows of the tokens outside it are
    zero, and the rows are summed over ``model`` (exact: one rank holds
    each token's row)."""
    table = params["table"]
    mesh = get_mesh()
    if mesh is None or table.shape[0] == cfg.vocab:
        x = table[tokens].to(cfg.dtype)
    else:
        lay = tp.layout(mesh)
        rows = table.shape[0]
        local = tokens - lay.model_index * rows
        mine = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)].to(cfg.dtype)
        x = tp.sum_over(torch.where(mine[..., None], x, 0.0), lay.model)
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype)
    return x


def unembed(table: torch.Tensor, x: torch.Tensor, *,
            vocab: "int | None" = None) -> torch.Tensor:
    """Logits x @ table.T for a (vocab, d_model) table. On a mesh, a
    table of fewer than ``vocab`` rows is this rank's ``model`` block of
    the vocab, and the blocks' logits are all-gathered over ``model``."""
    mesh = get_mesh()
    if mesh is None or vocab is None or table.shape[0] == vocab:
        return x @ table.T.to(x.dtype)
    model = tp.layout(mesh).model
    logits = tp.replicated_input(x, model) @ table.T.to(x.dtype)
    return tp.gather(logits, model, -1)


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


def mesh_cross_entropy(feats: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, mask=None, *, vocab: int,
                       chunk: int = 0, model=None, model_index: int = 0,
                       rows=None) -> torch.Tensor:
    """``lm_cross_entropy`` (``chunk`` 0) or ``chunked_cross_entropy``
    over a mesh: ``feats``, ``labels`` and ``mask`` are this rank's rows
    of the batch, split over the group ``rows`` (None: every row is
    here), and ``table`` the whole (vocab, D) table or this rank's
    ``model`` block of the vocab (block ``model_index`` of the group
    ``model``). A vocab block's logits give their max (no gradient) and
    their sum of exponentials, summed over ``model``, and the gold logit
    comes from the rank that holds its row (``lm_cross_entropy``'s
    <feats, table[label]>, or the chunked CE's gathered logit). The CE is
    the global masked sum over the global count: both summed over
    ``rows``. Without either split it is the no-mesh function itself."""
    if rows is None and table.shape[0] == vocab:
        if chunk:
            return chunked_cross_entropy(feats, table, labels, chunk, mask)
        return lm_cross_entropy(feats, table, labels, mask)
    b, t, _ = feats.shape
    if chunk and t % chunk:
        raise ValueError(f"sequence length {t} must be divisible by the "
                         f"cross-entropy chunk {chunk}")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
            if mask is None else mask.float())
    n = table.shape[0]
    split = n != vocab
    if split:
        feats = tp.replicated_input(feats, model)
    tab = table.T.to(feats.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=feats.device)
    cnt = torch.zeros((), dtype=torch.float32, device=feats.device)
    step = chunk or t
    for c0 in range(0, t, step):
        f = feats[:, c0:c0 + step]
        mk = mask[:, c0:c0 + step]
        local = labels[:, c0:c0 + step].long() - (model_index * n if split
                                                  else 0)
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        logits = (f @ tab).float()
        if chunk:
            gold = torch.gather(logits, -1, local[..., None])[..., 0]
        else:
            gold = torch.einsum("btd,btd->bt", f.float(), table[local].float())
        if split:
            top = tp.max_over(logits.amax(dim=-1), model)
            sums = tp.sum_over(torch.stack([
                torch.exp(logits - top[..., None]).sum(dim=-1),
                torch.where(mine, gold, 0.0)]), model)
            nll = torch.log(sums[0]) + top - sums[1]
        else:
            nll = torch.logsumexp(logits, dim=-1) - gold
        tot = tot + torch.sum(nll * mk)
        cnt = cnt + torch.sum(mk)
    tot, cnt = tp.sum_over(torch.stack([tot, cnt]), rows)
    return tot / torch.clamp(cnt, min=1.0)
