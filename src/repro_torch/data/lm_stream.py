"""Synthetic LM token streams for training (``repro.data.lm_stream``).

A deterministic Zipf-ish Markov token source, seedable and with enough
local structure that a small LM's loss drops within a few hundred steps.
The numpy draws are the reference's, one for one, so a seed gives the
same tokens in both packages; batches are int32 tensors on the device
the caller names.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


def _batch(toks: np.ndarray, dev: torch.device) -> dict:
    return {"inputs": torch.tensor(toks[:, :-1], dtype=torch.int32, device=dev),
            "labels": torch.tensor(toks[:, 1:], dtype=torch.int32, device=dev)}


@dataclasses.dataclass
class LMStream:
    """Hidden-state Markov chain emitting Zipf-distributed tokens."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    n_states: int = 64
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        self.trans = rng.dirichlet(np.ones(self.n_states) * 0.2,
                                   size=self.n_states)
        ranks = np.arange(1, self.vocab + 1)
        base = 1.0 / ranks**1.1
        self.emit = np.stack([
            np.roll(base, rng.integers(0, self.vocab))
            for _ in range(self.n_states)])
        self.emit /= self.emit.sum(axis=1, keepdims=True)

    def batches(self, n_steps: int):
        rng = np.random.default_rng(self.seed + 1)
        for _ in range(n_steps):
            toks = np.empty((self.batch, self.seq_len + 1), np.int32)
            state = rng.integers(0, self.n_states, size=self.batch)
            for t in range(self.seq_len + 1):
                for b in range(self.batch):
                    toks[b, t] = rng.choice(self.vocab, p=self.emit[state[b]])
                    state[b] = rng.choice(self.n_states,
                                          p=self.trans[state[b]])
            yield _batch(toks, self.dev)


class FastLMStream:
    """Vectorized variant: token_{t+1} ~ mix(bigram[token_t], zipf), with
    the deterministic bigram taken with probability ``bigram_weight``."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 bigram_weight: float = 0.7,
                 device: "str | torch.device" = "cuda"):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        self.dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.shift = rng.integers(1, vocab, size=vocab)  # deterministic bigram
        ranks = np.arange(1, vocab + 1)
        self.zipf = 1.0 / ranks**1.1
        self.zipf /= self.zipf.sum()
        self.w = bigram_weight

    def batches(self, n_steps: int):
        rng = np.random.default_rng(self.seed + 1)
        for _ in range(n_steps):
            toks = np.empty((self.batch, self.seq_len + 1), np.int64)
            toks[:, 0] = rng.choice(self.vocab, p=self.zipf, size=self.batch)
            for t in range(self.seq_len):
                follow = (toks[:, t] + self.shift[toks[:, t]]) % self.vocab
                rand = rng.choice(self.vocab, p=self.zipf, size=self.batch)
                use_bigram = rng.random(self.batch) < self.w
                toks[:, t + 1] = np.where(use_bigram, follow, rand)
            yield _batch(toks, self.dev)
