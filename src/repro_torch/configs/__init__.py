"""Architecture registry: the 10 assigned configs and the input-shape
registry, as in ``repro.configs`` (configs are architectures only; the
weights are random at init)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = (
    "kimi_k2_1t_a32b",
    "recurrentgemma_2b",
    "mamba2_780m",
    "gemma3_4b",
    "llama32_vision_90b",
    "tinyllama_1_1b",
    "qwen15_110b",
    "gemma3_1b",
    "whisper_tiny",
    "arctic_480b",
)

# public ids as assigned (hyphens) -> module names
_ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-780m": "mamba2_780m",
    "gemma3-4b": "gemma3_4b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-110b": "qwen15_110b",
    "gemma3-1b": "gemma3_1b",
    "whisper-tiny": "whisper_tiny",
    "arctic-480b": "arctic_480b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    """Arch id, optionally with a variant suffix: "gemma3-4b@rightsized"
    (right-sized caches; ``LM`` builds them with the ``dense_sb`` group
    kind, which raises until its slice is ported)."""
    variant = None
    if "@" in arch:
        arch, variant = arch.split("@", 1)
    mod_name = _ALIASES.get(arch, arch)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_ALIASES)}")
    cfg = importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
    if variant == "rightsized":
        cfg = dataclasses.replace(cfg, cache_mode="rightsized")
    elif variant:
        raise ValueError(f"unknown variant {variant!r}")
    return cfg
