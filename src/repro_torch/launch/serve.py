"""Serving launcher: batched prefill + greedy decode, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --device cpu --prompt-len 64

Weights are random, drawn from ``--seed``; prompts are random tokens
from a second stream of the same seed, which then draws the reference's
synthetic payloads: a vlm's patch embeddings ``vision`` (B,
vision_tokens, vision_dim) and whisper's frame embeddings
``audio_frames`` (B, audio_frames, d_model), standard normal float32.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.base import root_key
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg)
    params = model.init(root_key(args.seed, device=dev))
    batch_gen = root_key(args.seed, 1, device=dev)
    batch = {"inputs": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=batch_gen, device=dev)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(
            (args.batch, cfg.vision_tokens, cfg.vision_dim),
            generator=batch_gen, device=dev)
    if cfg.family == "audio":
        batch["audio_frames"] = torch.randn(
            (args.batch, cfg.audio_frames, cfg.d_model), generator=batch_gen,
            device=dev)

    cache_len = args.prompt_len + args.gen
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = model.prefill(params, batch, cache_len=cache_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        toks = torch.argmax(logits, dim=-1)[:, None]
        generated = [toks]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, state = model.decode_step(params, state, toks)
            toks = torch.argmax(logits, dim=-1)[:, None]
            generated.append(toks)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.arch_id} batch={args.batch} prompt={args.prompt_len} "
          f"device={name}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:,.0f} tok/s)")
    print(f"decode : {t_decode*1e3:.1f} ms for {args.gen-1} steps "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):,.0f} tok/s)")
    print("sample tokens:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
