"""Continuous-batching serving engine, the counterpart of
``repro.serving.engine``.

Slot-based scheduler over a fixed decode batch: every sequence sits at
its own position (a per-slot ``index`` vector, see
``attention.attn_decode``), so new requests are admitted into free slots
while others are mid-generation.

  * admit: single-request prefill (prompt right-padded to a power-of-two
    bucket, at least 16 and at most ``cache_len``), the cache slots the
    padding wrote invalidated, the state written into the free slot along
    each leaf's batch axis. A model with a recurrent state (``ssd``,
    ``rec``, ``griffin`` groups) or right-sized ring caches
    (``LM.exact_prefill``) takes no padding, which its state would absorb
    or which would push the prompt's last real keys out of a ring: the
    prompt's longest prefix ``prefill`` takes (all of it but for an
    ``ssd`` group) goes through ``prefill`` and the rest, fewer than
    ``cfg.ssm_chunk`` tokens, through ``decode_step`` on the one-row
    state;
  * step: one batched decode for all slots;
  * complete: slots free as sequences hit ``max_new_tokens`` or EOS.

Correctness contract (as ``tests/test_serving_engine.py`` states it for
the reference): every request's continuous-batched output equals its
isolated prefill + greedy-decode output exactly.

Under a mesh (``sharding.ctx.use_mesh``) every rank runs this loop on
the global batch's logits, which ``LM.prefill`` and ``LM.decode_step``
return on every rank, with ``params`` the rank's serving shard and the
decode state its shard under ``rules.state_spec``: the slots' rows over
``data``, their sequence over ``model`` (a right-sized ring's
``min(window, cache_len)`` slots apart from the global caches'), an ssm
state's heads over ``model`` (conv and RG-LRU states whole there). A
recurrent or right-sized prompt's unpadded admission runs its prefix
through ``prefill`` and its tail through ``decode_step`` on the mesh
alike. A request's prefill state (one row, its sequence over ``data``
and ``model``) is gathered whole and cut to the slots' layout along each
leaf's batch axis (2 for a ``dense_sb`` ring (n, per, B, S, ...)), and
the rank that holds row ``slot`` writes it (``_insert``). The engine
takes no memory, so the vlm and dec kinds serve through ``LM.prefill``
and ``LM.decode_step`` alone, as without a mesh.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.sharding import rules
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.ctx import get_mesh, use_mesh
from repro_torch.tree import leaves, tree_map


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


def _batch_axis(one: torch.Tensor, two: torch.Tensor) -> int:
    for axis, (a, b) in enumerate(zip(one.shape, two.shape)):
        if a != b:
            return axis
    raise ValueError(f"a state leaf {tuple(one.shape)} has no batch axis")


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
        # each state leaf's batch axis: the first axis on which the shapes
        # of a batch-1 and a batch-2 state differ (the reference's
        # structural discovery; global shapes only, on the meta device)
        self._batch_axes = [
            tree_map(_batch_axis, one, two) for one, two in zip(
                *(self._global_state(b) for b in (1, 2)))]
        self.active = np.zeros(max_batch, dtype=bool)
        self.last_tokens = np.zeros(max_batch, dtype=np.int64)

    def _global_state(self, batch: int) -> list:
        """The groups of a ``batch``-row decode state of the global shapes,
        on the meta device."""
        with use_mesh(None):
            return self.model.init_decode_state(
                batch, self.cache_len, device="meta")["groups"]

    # -- state surgery ---------------------------------------------------------
    def _insert(self, single_state: dict, slot: int, index: int) -> None:
        """Write a one-row prefill state into batch row ``slot`` at
        position ``index``, along each leaf's batch axis ((L, B, ...), a
        ``dense_sb`` ring's (n, per, B, ...))."""
        mesh = get_mesh()
        if mesh is not None:
            self._insert_on_mesh(mesh, single_state, slot)
        else:
            def put(big, small, axis):
                big.select(axis, slot).copy_(small.select(axis, 0))
            for big, small, axes in zip(self.state["groups"],
                                        single_state["groups"],
                                        self._batch_axes):
                tree_map(put, big, small, axes)
        self.state["index"][slot] = index

    def _insert_on_mesh(self, mesh, single_state: dict, slot: int) -> None:
        """``_insert`` of the rank's shards: each leaf of the one-row state
        gathered whole (its ``state_spec`` at batch 1), cut to the slots'
        layout (``state_spec`` at ``max_batch``, the batch axis aside),
        and written by the rank whose rows hold ``slot``."""
        lay = tp.layout(mesh)
        one, full = ([leaves(rules.tree_specs(mesh, g, rules.state_spec,
                                              batch=b))
                      for g in self._global_state(b)]
                     for b in (1, self.max_batch))
        bigs, smalls, axes = ([leaves(g) for g in tree]
                              for tree in (self.state["groups"],
                                           single_state["groups"],
                                           self._batch_axes))
        flat = [(big, small, axis, s1, s2)
                for gs in zip(bigs, smalls, axes, one, full)
                for big, small, axis, s1, s2 in zip(*gs)]
        wholes = tp.unshard_all([(small, s1, ()) for _, small, _, s1, _ in flat],
                                lay)
        for (big, _, axis, _, spec), whole in zip(flat, wholes):
            cut = tuple(None if d == axis else ax for d, ax in enumerate(spec))
            piece = rules.local_shard(mesh, whole, cut)
            row0, rows, _ = lay.block(spec, axis, self.max_batch)
            if row0 <= slot < row0 + rows:
                big.select(axis, slot - row0).copy_(piece.select(axis, 0))

    @staticmethod
    def _mask_padded_positions(state: dict, true_len: int) -> dict:
        """Invalidate cache slots written by right-padding garbage: every
        ``pos`` leaf of the state's groups, nested dicts included."""
        def walk(node):
            for name, sub in node.items():
                if isinstance(sub, dict):
                    walk(sub)
                elif name == "pos":
                    sub.masked_fill_(sub >= true_len, -1)
        for cache in state["groups"]:
            walk(cache)
        return state

    # -- admission ----------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _exact_prefix(self, n: int) -> int:
        """The longest prefix of an n-token prompt that ``prefill`` takes
        exactly: all of it for the rglru kinds; for an ``ssd`` group, all
        of it when n <= ssm_chunk or a multiple of it, else the longest
        multiple of ssm_chunk (``ssd_scan``'s chunks)."""
        chunk = self.model.cfg.ssm_chunk
        if (all(g.kind != "ssd" for g in self.model.groups) or n <= chunk
                or n % chunk == 0):
            return n
        return n - n % chunk

    def _prefill_exact(self, prompt: list):
        """A prompt's real tokens only (a recurrent or right-sized model):
        (the last token's logits (1, vocab), the one-row state at
        len(prompt))."""
        n = self._exact_prefix(len(prompt))
        toks = torch.as_tensor([prompt], dtype=torch.int64, device=self.device)
        logits, sstate = self.model.prefill(
            self.params, {"inputs": toks[:, :n]}, cache_len=self.cache_len)
        for i in range(n, len(prompt)):
            logits, sstate = self.model.decode_step(self.params, sstate,
                                                    toks[:, i:i + 1])
        return logits, sstate

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            ltrue = len(req.prompt)
            if self.model.exact_prefill:
                logits, sstate = self._prefill_exact(req.prompt)
                padded = False
            else:
                lpad = min(_bucket(ltrue), self.cache_len)
                toks = torch.zeros((1, lpad), dtype=torch.int64)
                toks[0, :ltrue] = torch.as_tensor(req.prompt)
                logits, sstate = self.model.prefill(
                    self.params, {"inputs": toks.to(self.device)},
                    cache_len=self.cache_len)
                sstate = self._mask_padded_positions(sstate, ltrue)
                padded = lpad != ltrue
            self._insert(sstate, slot, ltrue)
            if not padded:
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
