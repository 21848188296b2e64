"""Continuous-batching serving engine, the counterpart of
``repro.serving.engine``.

Slot-based scheduler over a fixed decode batch: every sequence sits at
its own position (a per-slot ``index`` vector, see
``attention.attn_decode``), so new requests are admitted into free slots
while others are mid-generation.

  * admit: single-request prefill (prompt right-padded to a power-of-two
    bucket, at least 16 and at most ``cache_len``), the cache slots the
    padding wrote invalidated, the state written into the free slot;
  * step: one batched decode for all slots;
  * complete: slots free as sequences hit ``max_new_tokens`` or EOS.

Correctness contract (as ``tests/test_serving_engine.py`` states it for
the reference): every request's continuous-batched output equals its
isolated prefill + greedy-decode output exactly.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list  # token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(self, model: LM, params: dict, *, max_batch: int = 4,
                 cache_len: int = 512):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = params["embed"]["table"].device
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * max_batch

        self.state = model.init_decode_state(max_batch, cache_len,
                                             device=self.device)
        self.state["index"] = torch.zeros(max_batch, dtype=torch.int32,
                                          device=self.device)
        self.active = np.zeros(max_batch, dtype=bool)
        self.last_tokens = np.zeros(max_batch, dtype=np.int64)

    # -- state surgery ---------------------------------------------------------
    def _insert(self, single_state: dict, slot: int, index: int) -> None:
        """Write a one-row prefill state into batch row ``slot`` at
        position ``index``: every cache leaf is (L, B, ...)."""
        for big, small in zip(self.state["groups"], single_state["groups"]):
            for name, leaf in big.items():
                leaf[:, slot] = small[name][:, 0].to(leaf.dtype)
        self.state["index"][slot] = index

    @staticmethod
    def _mask_padded_positions(state: dict, true_len: int) -> dict:
        """Invalidate cache slots written by right-padding garbage."""
        for cache in state["groups"]:
            cache["pos"].masked_fill_(cache["pos"] >= true_len, -1)
        return state

    # -- admission ----------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            ltrue = len(req.prompt)
            lpad = min(_bucket(ltrue), self.cache_len)
            toks = torch.zeros((1, lpad), dtype=torch.int64)
            toks[0, :ltrue] = torch.as_tensor(req.prompt)
            logits, sstate = self.model.prefill(
                self.params, {"inputs": toks.to(self.device)},
                cache_len=self.cache_len)
            sstate = self._mask_padded_positions(sstate, ltrue)
            self._insert(sstate, slot, ltrue)
            if lpad == ltrue:
                first = int(torch.argmax(logits[0]))
                self.last_tokens[slot] = first
                req.generated.append(first)
            else:
                # the logits of a padded prompt are the padding's: replay
                # the last real token through one decode step at ltrue - 1
                self.state["index"][slot] = ltrue - 1
                self.last_tokens[slot] = req.prompt[-1]
            self.slots[slot] = req
            self.active[slot] = True

    # -- one engine iteration --------------------------------------------------------
    def step(self) -> int:
        """Admit + one batched decode. Returns number of active slots."""
        self._admit()
        if not self.active.any():
            return 0
        toks = torch.from_numpy(self.last_tokens[:, None]).to(self.device)
        logits, self.state = self.model.decode_step(self.params, self.state,
                                                    toks)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot in range(self.max_batch):
            req = self.slots[slot]
            if req is None:
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.generated) >= req.max_new_tokens or hit_eos:
                req.done = True
                self.slots[slot] = None
                self.active[slot] = False
        return int(self.active.sum())

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and not self.active.any():
                return
            self.step()
        raise RuntimeError("serving run() exceeded max_steps")
