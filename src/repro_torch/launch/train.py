"""Training launcher: AdamW LM steps on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 12 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --device cpu --steps 20 --batch 4 --seq 64

The reference's CLI (``repro.launch.train``) and its printed lines, plus
``--device`` (default ``cuda``). Weights are random, drawn from
``--seed``; the tokens come from ``FastLMStream`` with the same seed.
On the card the attention's gradient runs through the flash-attention
backward kernel. ``--ckpt-dir`` saves parameters and optimizer state
every ``--ckpt-every`` steps and at the end, and resumes from the latest
step found there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.core.base import root_key
from repro_torch.data.lm_stream import FastLMStream
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.optim import adamw_init, adamw_update, linear_warmup_cosine
from repro_torch.tree import leaves, unflatten

WARMUP_STEPS = 20


def loss_and_grads(model: LM, params: dict, batch: dict):
    """(loss, metrics, grads): ``model.loss`` at ``params`` and its
    gradient with respect to every leaf, a tree like ``params`` (the
    reference's ``jax.value_and_grad(..., has_aux=True)``); under a mesh
    each rank's block of the global loss's gradient."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = model.loss(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {name: m.detach() for name, m in metrics.items()},
            unflatten(params, grads))


def train_step(model: LM, params: dict, opt_state: dict, batch: dict, lr):
    """One AdamW step on ``batch``: (params, opt_state, loss, ce, gnorm).
    Under a mesh ``params`` and ``opt_state``'s moments are the rank's
    training shards (``rules.training_shard``) and ``batch`` the global
    batch; loss, ce and gnorm are the same on every rank."""
    loss, metrics, grads = loss_and_grads(model, params, batch)
    params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr=lr,
                                            specs=model.param_specs())
    return params, opt_state, loss, metrics["ce"], gnorm


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        overrides = {}
        if args.d_model:
            overrides["d_model"] = args.d_model
        if args.n_layers:
            overrides["n_layers"] = args.n_layers
        if args.vocab:
            overrides["vocab"] = args.vocab
        cfg = cfg.reduced(**overrides)
    model = LM(cfg)

    params = model.init(root_key(args.seed, device=dev))
    opt_state = adamw_init(params)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.arch_id} params={n_params/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab}")

    start = 0
    if args.ckpt_dir:
        st = latest_step(args.ckpt_dir)
        if st is not None:
            params = restore(args.ckpt_dir, st, params)
            opt_state = restore(args.ckpt_dir + "/opt", st, opt_state)
            start = st
            print(f"restored step {st}")

    stream = FastLMStream(cfg.vocab, args.seq, args.batch, seed=args.seed,
                          device=dev)
    t0 = time.perf_counter()
    losses = []
    for step, batch in enumerate(stream.batches(args.steps - start),
                                 start=start):
        lr = linear_warmup_cosine(step, base_lr=args.lr,
                                  warmup_steps=WARMUP_STEPS,
                                  total_steps=args.steps)
        params, opt_state, loss, ce, gnorm = train_step(
            model, params, opt_state, batch, lr)
        losses.append(float(ce))
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = (step - start + 1) * args.batch * args.seq / (
                time.perf_counter() - t0)
            print(f"step {step:5d}  ce={float(ce):.4f}  "
                  f"gnorm={float(gnorm):.3f}  tok/s={tps:,.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, params)
            save(args.ckpt_dir + "/opt", step + 1, opt_state)

    if args.ckpt_dir:
        save(args.ckpt_dir, args.steps, params)
        save(args.ckpt_dir + "/opt", args.steps, opt_state)
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"ce first10={first:.4f} last10={last:.4f} "
          f"improvement={(first - last):.4f}")


if __name__ == "__main__":
    main()
