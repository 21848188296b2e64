"""Client participation policies.

Counterpart of ``repro.comm.scheduler``. A scheduler decides, per round,
which of the ``m`` clients are asked to participate; the mask reweights
server aggregation (masked, renormalized ``client_weights``).

  * ``FullParticipation``  — every client, every round.
  * ``UniformSampler(q)``  — a uniform sample of ceil(q*m) clients
                             without replacement.
  * ``BandwidthAware(q)``  — ceil(q*m) clients with probability
                             proportional to uplink bandwidth (the Gumbel
                             top-k trick over log-bandwidth scores).

Each draw is a pure function of a host key (drawn on the CPU with a
seeded generator), so the same ``(seed, round)`` gives the same cohort.
``participants`` (an (m,) mask) and ``sample_ids`` (the sorted cohort
ids, the form client populations consume) are two views of the SAME
draw; ``cohort_size`` is the static number of ids a round samples.

Churn (``repro_torch.dynamics``): every policy takes an optional
``eligible`` id array restricting the draw to the clients alive this
round. The restricted path draws *indices into the eligible set*; with
``eligible=None`` each policy runs the draw it runs without dynamics.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.comm.channel import ChannelModel
from repro_torch.keys import generator

SCHEDULER_SPECS = ("full", "uniform:<q>", "bandwidth:<q>")


class Scheduler:
    name: str = "scheduler"

    def participants(self, key: torch.Tensor, round_idx: int, m: int,
                     channel: ChannelModel, eligible=None) -> np.ndarray:
        """(m,) bool mask of the clients scheduled this round."""
        mask = np.zeros((m,), dtype=bool)
        mask[self.sample_ids(key, round_idx, m, channel,
                             eligible=eligible)] = True
        return mask

    def sample_ids(self, key: torch.Tensor, round_idx: int, m: int,
                   channel: ChannelModel, eligible=None) -> np.ndarray:
        """Sorted int64 client ids of this round's cohort (the draw of
        ``participants``, O(cohort) output); ``eligible`` (sorted ids)
        restricts the draw to churn's survivors."""
        raise NotImplementedError

    def cohort_size(self, m: int) -> int:
        """Static number of clients sampled per round (an upper bound
        under churn: a shrunken eligible set gives fewer ids)."""
        return m

    @property
    def is_full(self) -> bool:
        return False


class FullParticipation(Scheduler):
    name = "full"

    def participants(self, key, round_idx, m, channel, eligible=None):
        if eligible is None:
            return np.ones((m,), dtype=bool)
        mask = np.zeros((m,), dtype=bool)
        mask[eligible] = True
        return mask

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        if eligible is None:
            return np.arange(m, dtype=np.int64)
        return np.asarray(eligible, dtype=np.int64)

    @property
    def is_full(self):
        return True


@dataclasses.dataclass(frozen=True)
class UniformSampler(Scheduler):
    """Uniform-without-replacement sample of a q-fraction each round."""

    q: float = 0.5

    @property
    def name(self):
        return f"uniform:{self.q}"

    def _count(self, m: int) -> int:
        return max(1, min(m, int(math.ceil(self.q * m))))

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        if eligible is None:
            perm = torch.randperm(m, generator=generator(key, "cpu"))
            return np.sort(perm[:self._count(m)].numpy().astype(np.int64))
        eligible = np.asarray(eligible, dtype=np.int64)
        n = len(eligible)
        # indices INTO the eligible set: the cohort follows the shrunken
        # population
        perm = torch.randperm(n, generator=generator(key, "cpu"))
        chosen = perm[:min(self._count(m), n)].numpy()
        return np.sort(eligible[chosen])

    def cohort_size(self, m: int) -> int:
        return self._count(m)


@dataclasses.dataclass(frozen=True)
class BandwidthAware(UniformSampler):
    """Bandwidth-proportional sampling: fast uplinks participate more
    (Gumbel top-k over log-bandwidth; uniform when all links match)."""

    q: float = 0.5

    @property
    def name(self):
        return f"bandwidth:{self.q}"

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        n = m if eligible is None else len(eligible)
        u = torch.rand(n, generator=generator(key, "cpu"),
                       dtype=torch.float64).numpy()
        gumbel = -np.log(-np.log(np.maximum(u, np.finfo(np.float64).tiny)))
        if eligible is None:
            scores = np.log(channel.uplink_rates(m)) + gumbel
            top = np.argsort(-scores, kind="stable")[:self._count(m)]
            return np.sort(top.astype(np.int64))
        eligible = np.asarray(eligible, dtype=np.int64)
        scores = np.log(channel.uplink_rates_for(eligible, m)) + gumbel
        top = np.argsort(-scores, kind="stable")[:min(self._count(m), n)]
        return np.sort(eligible[top])


def make_scheduler(spec: "str | Scheduler") -> Scheduler:
    """``"full" | "uniform:<q>" | "bandwidth:<q>"`` or a Scheduler."""
    if isinstance(spec, Scheduler):
        return spec
    if spec == "full":
        return FullParticipation()
    kind, _, arg = str(spec).partition(":")
    known = ", ".join(repr(s) for s in SCHEDULER_SPECS)
    try:
        if kind == "uniform":
            return UniformSampler(q=float(arg or 0.5))
        if kind == "bandwidth":
            return BandwidthAware(q=float(arg or 0.5))
    except ValueError:
        raise ValueError(
            f"bad parameter in scheduler spec {spec!r} (q must be a "
            f"float); expected one of {known}") from None
    raise ValueError(
        f"unknown scheduler spec {spec!r}; expected one of {known}")
