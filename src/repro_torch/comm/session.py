"""The ``Session`` protocol of the round loop.

Counterpart of ``repro.comm.session``. ``run_rounds`` drives every
session the same way:

  * ``prepare(round_fn)`` — once, before the first round (the
      asynchronous drivers fill their byte plan and dispatch the first
      cycles here);
  * ``begin_variant(sig)`` — announce the static round variant about to
      execute (``FederatedOptimizer.round_signature``; adaptive-k sketch
      policies change payload sizes mid-trajectory);
  * ``comm_round(memory, mask, codec_key)`` — the transport view the
      optimizer's round receives (``CommRound``, or a no-op view on the
      no-transport path);
  * ``step(round_fn)`` — advance one round and return the new optimizer
      state; ``round_fn(state, memory, key, mask, codec_key) -> (state,
      memory, stats)`` is the one round function every session shares
      (``stats``: the robust aggregators' counters, empty without them);
  * ``finalize() -> Transport`` — the transport axes for ``History``.

``make_session`` resolves ``comm=None`` to ``NullSession``, a
``CommConfig`` to ``CommSession`` or (``async_mode=True``)
``AsyncSession``, and over a ``ClientPopulation`` to
``PopulationCommSession`` or ``PopulationAsyncSession``. A population
round function takes the cohort problem first: ``round_fn(cohort, state,
memory, key, mask, codec_key)``.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.comm.async_driver import AsyncSession, PopulationAsyncSession
from repro_torch.comm.config import (
    DOWN,
    NULL_COMM,
    CommConfig,
    CommSession,
    PopulationCommSession,
    _NullComm,
    plan_bytes,
)
from repro_torch.comm.metrics import Transport
from repro_torch.obs import NULL_TELEMETRY


class Session:
    """Protocol base for round sessions (see module docstring)."""

    def prepare(self, round_fn) -> None:
        raise NotImplementedError

    def begin_variant(self, sig) -> None:
        raise NotImplementedError

    def comm_round(self, memory, mask, codec_key):
        raise NotImplementedError

    def step(self, round_fn) -> Any:
        raise NotImplementedError

    def finalize(self) -> Transport:
        raise NotImplementedError


def _nbytes(shape: torch.Size, x: torch.Tensor) -> int:
    """Identity-codec wire size: every element at its raw width."""
    return math.prod(shape) * x.element_size()


class _PlanRecorder(_NullComm):
    """``NULL_COMM`` that also records the identity-codec byte plan of
    every payload occurrence, both directions: the round's results are
    exactly those of ``NULL_COMM``. PyTorch has no shape-only trace, so
    the plan is recorded on the first executed round of each variant."""

    def __init__(self):
        self.plan: "dict[str, int]" = {}
        self._occurrences: "dict[str, int]" = {}

    def _record(self, name: str, nbytes: int) -> None:
        occ = self._occurrences.get(name, 0)
        self._occurrences[name] = occ + 1
        self.plan[name if occ == 0 else f"{name}#{occ}"] = nbytes

    def uplink(self, name, x, wire_shape=None, ef_eligible=True,
               ef_reset=None):
        shape = x.shape[1:] if wire_shape is None else wire_shape
        self._record(name, _nbytes(shape, x))  # per client
        return x

    def downlink(self, name, x, wire_shape=None):
        shape = x.shape if wire_shape is None else wire_shape
        self._record(f"{DOWN}{name}", _nbytes(shape, x))
        return x


class NullSession(Session):
    """No-transport session: rounds execute back to back with the no-op
    ``NULL_COMM`` view. The byte axis bills the identity-codec plan of
    the round (every payload occurrence at its raw size, both
    directions, for all m clients), recorded once per round variant, so
    adaptive-k trajectories bill their round-varying sizes.

    The reference probes each variant's plan in ``begin_variant`` (a
    shape-only trace, span ``probe_plan``, with a fallback counter
    ``plan_probe_fallbacks``); here the plan is recorded inside the
    variant's first real round, so neither name appears."""

    def __init__(self, keys: torch.Tensor, state0, m: int,
                 obs=NULL_TELEMETRY):
        self.keys = keys
        self._state = state0
        self.m = int(m)
        self.obs = obs
        self._plans: "dict[Any, dict[str, int]]" = {}
        self._sig = None
        self._view = NULL_COMM
        self._per_round: "list[float]" = []
        self._t = 0

    def prepare(self, round_fn) -> None:
        pass

    def begin_variant(self, sig) -> None:
        self._sig = sig

    def comm_round(self, memory, mask, codec_key):
        return self._view

    def step(self, round_fn) -> Any:
        key = self.keys[self._t]
        plan = self._plans.get(self._sig)
        if plan is None:
            self._view = _PlanRecorder()
            self._state, _, _ = round_fn(self._state, {}, key, None, None)
            plan = self._plans[self._sig] = self._view.plan
            self._view = NULL_COMM
        else:
            self._state, _, _ = round_fn(self._state, {}, key, None, None)
        per_client = plan_bytes(plan, down=False) + plan_bytes(plan, down=True)
        formula = float(per_client * self.m)
        self._per_round.append(formula)
        self._t += 1
        if self.obs.enabled:
            self.obs.metrics.counter("formula_bytes").inc(formula)
            self.obs.annotate(formula_bytes=formula)
        return self._state

    def finalize(self) -> Transport:
        per_round = np.asarray(self._per_round, dtype=np.float64)
        return Transport(
            cumulative_bytes=np.concatenate([[0.0], np.cumsum(per_round)]),
            sim_time_s=np.zeros(self._t + 1),
        )


def make_session(comm, *, m: int, keys: torch.Tensor, state0,
                 mask_dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda",
                 population=None, client_weights=None,
                 obs=NULL_TELEMETRY, client_mesh=None) -> Session:
    """Resolve the transport configuration to its session: ``None`` is
    the no-transport ``NullSession``, a ``CommConfig`` the lock-step
    ``CommSession`` or, with ``async_mode=True``, the event-driven
    ``AsyncSession`` (which weighs groups by ``client_weights``, (m,) on
    the host). A ``population`` selects ``PopulationCommSession`` or
    ``PopulationAsyncSession`` and needs a ``CommConfig``. ``obs`` is the
    run's telemetry (``repro_torch.obs.Telemetry``) or the shared no-op.
    ``client_mesh`` (a ``DeviceMesh``) splits each cohort of a population
    over the ranks of its client axis; a dense problem is not split."""
    if comm is not None and not isinstance(comm, CommConfig):
        raise TypeError(f"comm must be a repro_torch CommConfig or None, "
                        f"got {type(comm).__name__}")
    if population is not None:
        if comm is None:
            raise ValueError(
                "population runs need a CommConfig: pass run_rounds(..., "
                "comm=CommConfig(scheduler='uniform:q')) (materializing "
                "every client is what populations avoid; use "
                "population.materialize_all() for the dense problem)")
        cls = PopulationAsyncSession if comm.async_mode else PopulationCommSession
        return cls(comm, population, keys=keys, state0=state0,
                   mask_dtype=mask_dtype, device=device, obs=obs,
                   client_mesh=client_mesh)
    if comm is None:
        return NullSession(keys, state0, m, obs=obs)
    if comm.async_mode:
        return AsyncSession(comm, m, client_weights, keys=keys, state0=state0,
                            mask_dtype=mask_dtype, device=device, obs=obs)
    return CommSession(comm, m, keys=keys, state0=state0,
                       mask_dtype=mask_dtype, device=device, obs=obs)
