"""Host-side keys: one round's seed material as an int32 (2,) tensor.

JAX's threefry keys become two pieces in the port: a *key* (8 bytes on
the host, the size of a JAX ``uint32[2]`` key) and a ``torch.Generator``
seeded from it on the device that draws. ``key_from_ints`` derives a key
as a pure function of integers, ``generator`` turns a key into a
generator. Keys live on the host, so deriving one never waits on the
device. ``repro_torch.core.base`` builds the trajectory keys on these;
the transport derives its per-round and per-payload keys from them.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key_bits(key: torch.Tensor) -> int:
    """The 64 bits of a key as a Python int."""
    hi, lo = (int(v) & 0xFFFFFFFF for v in key.tolist())
    return (hi << 32) | lo


def _key_of(bits: int) -> torch.Tensor:
    hi, lo = bits >> 32, bits & 0xFFFFFFFF
    words = np.array([hi, lo], dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words.copy())


def key_from_ints(*ints: int) -> torch.Tensor:
    """A key that is a pure function of the integers (host only)."""
    bits = 0
    for v in ints:
        bits = _mix64(bits ^ (int(v) & _MASK64))
    return _key_of(bits)


def generator(key: torch.Tensor, device: "str | torch.device") -> torch.Generator:
    """A generator on ``device`` seeded from a key."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(key_bits(key))
    return gen


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from ``key`` and an integer (host only): the
    counterpart of ``jax.random.fold_in``, with other numbers."""
    return key_from_ints(key_bits(key), data)
