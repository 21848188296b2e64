"""Long-context decode on the PyTorch/CUDA port: O(1)-state SSM serving,
a hybrid's windowed attention, and a sliding-window model's KV caches,
uniform and right-sized.

Streams a long context through reduced Mamba-2, RecurrentGemma and
gemma3 (5 local : 1 global windows) models, then decodes continuations,
and prints each one's decode state: the serving memory a request holds.
gemma3 runs twice: with uniform caches (every layer keeps ``context +
gen`` slots) and ``@rightsized`` (each local layer keeps a ring of
``window`` slots, only the global layers the whole context).

Run me::

  PYTHONPATH=src python examples/long_context_decode_torch.py --context 2048        # on the card
  PYTHONPATH=src python examples/long_context_decode_torch.py --context 64 --gen 4 --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.base import root_key
from repro_torch.models.lm import LM
from repro_torch.tree import leaves

ARCHS = ("mamba2-780m", "recurrentgemma-2b", "gemma3-1b",
         "gemma3-1b@rightsized")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_bytes(state: dict) -> int:
    """Bytes of a decode state's tensors (its caches and recurrent
    states)."""
    return sum(leaf.numel() * leaf.element_size()
               for group in state["groups"] for leaf in leaves(group))


def run(arch: str, context: int, gen: int, device: str = "cuda") -> int:
    """Prefill ``context`` random tokens through ``arch`` reduced, decode
    ``gen`` greedy tokens; prints the times and the state's size and
    returns the size in bytes."""
    cfg = get_config(arch).reduced()
    model = LM(cfg)
    params = model.init(root_key(0, device=device))
    dev = params["embed"]["table"].device
    toks = torch.randint(0, cfg.vocab, (1, context),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"inputs": toks},
                                      cache_len=context + gen)
        _sync(dev)
        t_pre = time.perf_counter() - t0
        size = state_bytes(state)
        tok = logits.argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, state = model.decode_step(params, state, tok)
            tok = logits.argmax(-1, keepdim=True)
        _sync(dev)
        t_dec = (time.perf_counter() - t0) / gen
    print(f"{arch:>22} ctx={context:>6}  prefill={t_pre * 1e3:8.1f}ms  "
          f"decode={t_dec * 1e3:6.1f}ms/tok  state={size / 1e6:7.3f}MB")
    return size


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("(reduced configs; chip_smoke.py phase 11e serves the full-size "
          "gemma3 models at their published contexts)")
    return {arch: run(arch, args.context, args.gen, args.device)
            for arch in ARCHS}


if __name__ == "__main__":
    main()
