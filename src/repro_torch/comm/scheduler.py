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
draw; ``cohort_size`` is the static number of ids a round samples. The
churn restriction (``eligible=``) comes with the dynamics slice.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.comm.channel import ChannelModel
from repro_torch.keys import generator

SCHEDULER_SPECS = ("full", "uniform:<q>", "bandwidth:<q>")


def _no_churn(eligible) -> None:
    if eligible is not None:
        raise NotImplementedError(
            "churn (eligible=) comes with the dynamics slice of repro_torch")


class Scheduler:
    name: str = "scheduler"

    def participants(self, key: torch.Tensor, round_idx: int, m: int,
                     channel: ChannelModel, eligible=None) -> np.ndarray:
        """(m,) bool mask of the clients scheduled this round."""
        _no_churn(eligible)
        mask = np.zeros((m,), dtype=bool)
        mask[self.sample_ids(key, round_idx, m, channel,
                             eligible=eligible)] = True
        return mask

    def sample_ids(self, key: torch.Tensor, round_idx: int, m: int,
                   channel: ChannelModel, eligible=None) -> np.ndarray:
        """Sorted int64 client ids of this round's cohort (the draw of
        ``participants``, O(cohort) output)."""
        raise NotImplementedError

    def cohort_size(self, m: int) -> int:
        """Static number of clients sampled per round."""
        return m

    @property
    def is_full(self) -> bool:
        return False


class FullParticipation(Scheduler):
    name = "full"

    def participants(self, key, round_idx, m, channel, eligible=None):
        _no_churn(eligible)
        return np.ones((m,), dtype=bool)

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        _no_churn(eligible)
        return np.arange(m, dtype=np.int64)

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
        _no_churn(eligible)
        perm = torch.randperm(m, generator=generator(key, "cpu"))
        return np.sort(perm[:self._count(m)].numpy().astype(np.int64))

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
        _no_churn(eligible)
        u = torch.rand(m, generator=generator(key, "cpu"),
                       dtype=torch.float64).numpy()
        gumbel = -np.log(-np.log(np.maximum(u, np.finfo(np.float64).tiny)))
        scores = np.log(channel.uplink_rates(m)) + gumbel
        top = np.argsort(-scores, kind="stable")[:self._count(m)]
        return np.sort(top.astype(np.int64))


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
