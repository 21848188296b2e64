"""Client-side error-feedback memory for lossy uplink codecs.

Counterpart of ``repro.comm.feedback`` for the dense client axis (the
bounded population store comes with the populations slice). Each client
remembers, per payload, what its codec dropped and re-offers it in later
rounds. Two recursions, both from zero memory, with the wire format (and
so the billed bytes) unchanged:

``ef21`` (default) — the memory ``g`` is the payload estimate the server
mirrors; the wire carries the compressed innovation:

    transmit   c_t     = C(x_t - g_t)
    estimate   g_{t+1} = g_t + c_t          (what the server now holds)

``ef14`` — classic error compensation; the memory ``e`` is the residual:

    transmit   m_t     = C(x_t + e_t)
    remember   e_{t+1} = (x_t + e_t) - m_t

The memory is a dict of stacked ``(m, ...)`` tensors, one per EF-active
payload occurrence, that the session threads through every round next to
the optimizer state. PyTorch has no shape-only trace, so a payload's
memory is zero-initialized at its first uplink (``init_memory``), which
equals the reference's probe-then-zero start. Dropped clients' rows stay
frozen (``CommRound.where_delivered``). Only payloads whose basis
persists across rounds are eligible (``uplink(..., ef_eligible=...)``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.comm.codecs import Codec

EF_VARIANTS = ("ef21", "ef14")


def ef_requested(error_feedback: Any, payload: str) -> bool:
    """Resolve the per-payload gate from a ``CommConfig.error_feedback``
    spec: ``bool`` (all/none), a collection of payload names, or a
    ``{name: bool}`` dict with an optional ``"default"`` fallback."""
    if isinstance(error_feedback, bool):
        return error_feedback
    if isinstance(error_feedback, str):  # one payload name, not chars
        return payload == error_feedback
    if isinstance(error_feedback, dict):
        return bool(error_feedback.get(
            payload, error_feedback.get("default", False)))
    return payload in error_feedback


def any_ef_requested(error_feedback: Any) -> bool:
    """Whether the spec can enable EF for at least one payload name."""
    if isinstance(error_feedback, bool):
        return error_feedback
    if isinstance(error_feedback, str):
        return bool(error_feedback)
    if isinstance(error_feedback, dict):
        return any(bool(v) for v in error_feedback.values())
    return len(tuple(error_feedback)) > 0


def compensate(codec: Codec, u: "torch.Tensor | None", x: torch.Tensor,
               mem: torch.Tensor, variant: str = "ef21"
               ) -> "tuple[torch.Tensor, torch.Tensor]":
    """One error-feedback step on a stacked ``(m, ...)`` payload with its
    codec noise ``u``. Returns ``(decoded, new_mem)``.

    * ``ef21``: the wire carries ``C(x - g)``; decoded payload and new
      memory are both ``g + C(x - g)``.
    * ``ef14``: the wire carries ``C(x + e)``; the client keeps
      ``(x + e) - C(x + e)``.
    """
    if variant == "ef21":
        innovation = codec.roundtrip(x - mem, u)
        estimate = mem + innovation
        return estimate, estimate
    if variant == "ef14":
        compensated = x + mem
        decoded = codec.roundtrip(compensated, u)
        return decoded, compensated - decoded
    raise ValueError(
        f"unknown error-feedback variant {variant!r}; want one of {EF_VARIANTS}")


def init_memory(like: "Dict[str, torch.Tensor]") -> "Dict[str, torch.Tensor]":
    """Zero memories shaped like the given payloads."""
    return {name: torch.zeros_like(x) for name, x in like.items()}


def residual_norms(memory: "Dict[str, torch.Tensor]") -> "Dict[str, float]":
    """Per-payload Frobenius norm of the stacked memory (all clients)."""
    return {name: float(torch.linalg.vector_norm(e))
            for name, e in memory.items()}
