"""Client-side error-feedback memory for lossy uplink codecs.

Counterpart of ``repro.comm.feedback``. Each client
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

Client populations keep EF rows only for an LRU hot set of client ids
(``BoundedMemory``): O(capacity) rows on the device whatever m is.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.comm.codecs import Codec
from repro_torch.device import host_to

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


class BoundedMemory:
    """LRU-bounded EF row store for population runs.

    Dense EF keeps a memory row per client per payload, O(m) state a
    population must not hold. This store keeps rows only for a hot set
    of ``capacity`` client ids with LRU eviction; an id outside the hot
    set re-enters with a zero row (the on-sample reset). Per round the
    session calls ``gather(ids)`` for the cohort-stacked ``(c, ...)``
    rows (assigning slots to new ids, evicting the least recently
    sampled) and ``scatter(ids, memory)`` to write the round's rows back.
    Slot bookkeeping is host-side O(c); the rows live on the device.

    PyTorch has no shape-only trace, so the row buffers are allocated at
    the first ``scatter`` from the rows it writes (``gather`` before that
    returns ``{}``, which the round reads as zero memory); slots are
    assigned from the first ``gather`` on, as the reference assigns them.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"BoundedMemory capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._bufs: Dict[str, torch.Tensor] = {}
        self._slot_of: "dict[int, int]" = {}  # client id -> slot (LRU order)
        self._free: "list[int]" = []  # slots released by retire()
        self.evictions = 0  # long-tail resets observed so far
        self.retirements = 0

    @property
    def payload_names(self):
        return tuple(self._bufs)

    @property
    def nbytes(self) -> int:
        """Footprint: capacity x the per-payload row bytes."""
        return int(sum(b.numel() * b.element_size()
                       for b in self._bufs.values()))

    def _assign(self, ids: Sequence[int]) -> "tuple[list[int], list[int]]":
        """Slots for ``ids`` (LRU-refreshed), and the newly assigned ones."""
        fresh = []
        for cid in ids:
            cid = int(cid)
            if cid in self._slot_of:
                self._slot_of[cid] = self._slot_of.pop(cid)  # refresh
                continue
            if self._free:
                slot = self._free.pop()
            elif len(self._slot_of) < self.capacity:
                # slots [0, len(_slot_of) + len(_free)) are allocated
                slot = len(self._slot_of) + len(self._free)
            else:
                # evict the least recently sampled id (oldest entry)
                victim = next(iter(self._slot_of))
                slot = self._slot_of.pop(victim)
                self.evictions += 1
            self._slot_of[cid] = slot
            fresh.append(slot)
        return [self._slot_of[int(c)] for c in ids], fresh

    def _index(self, slots: "list[int]") -> torch.Tensor:
        dev = next(iter(self._bufs.values())).device
        return host_to(slots, dev, torch.int64)

    def gather(self, ids) -> Dict[str, torch.Tensor]:
        """Cohort-stacked ``(c, ...)`` rows for ``ids``; ids new to the
        hot set (or evicted since last sampled) read zeros."""
        if len(ids) > self.capacity:
            raise ValueError(
                f"cohort of {len(ids)} exceeds EF hot-set capacity "
                f"{self.capacity}; raise CommConfig.ef_capacity")
        slots, fresh = self._assign(ids)
        if not self._bufs:
            return {}
        if fresh:
            z = self._index(fresh)
            for buf in self._bufs.values():
                buf[z] = 0
        idx = self._index(slots)
        return {name: buf[idx] for name, buf in self._bufs.items()}

    def scatter(self, ids, memory: Dict[str, torch.Tensor]) -> None:
        """Write the round's updated rows back (``ids`` unique; rows past
        ``len(ids)`` are cohort padding and are not written)."""
        if not memory:
            return
        if not self._bufs:
            self._bufs = {
                name: rows.new_zeros((self.capacity,) + tuple(rows.shape[1:]))
                for name, rows in memory.items()}
        idx = self._index([self._slot_of[int(c)] for c in ids])
        for name, buf in self._bufs.items():
            buf[idx] = memory[name][:len(ids)]

    def retire(self, ids) -> int:
        """Drop (and zero) the hot-set rows of departed clients and free
        their slots; ids not in the hot set are ignored."""
        gone = [int(c) for c in ids if int(c) in self._slot_of]
        if not gone:
            return 0
        slots = [self._slot_of.pop(c) for c in gone]
        if self._bufs:
            z = self._index(slots)
            for buf in self._bufs.values():
                buf[z] = 0
        self._free.extend(slots)
        self.retirements += len(gone)
        return len(gone)

    def residual_norms(self) -> Dict[str, float]:
        return residual_norms(self._bufs)
