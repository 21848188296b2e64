"""Population churn: which clients exist at round ``t``.

Counterpart of ``repro.dynamics.churn``. A ``ChurnProcess`` is a
deterministic map from ``(seed, client_id, round)`` to alive/departed:
no mutable state, no ``(m,)`` history. Client ``j``'s lifetime is a pure
function of its per-id draws, so eligibility is the same in every
driver, at any cohort composition, and an m-client population holds only
the O(m) per-id parameter vectors it draws once (cached per m).

Processes (spec grammar, parsed by ``make_churn``):

  * ``"step:t=T[,frac=f]"`` — a seeded ``f``-fraction of the population
    departs for good at round ``T`` (``frac`` 0.5 by default); the
    positional form ``"step:T,f"`` parses too.
  * ``"poisson:rate"`` — every client alternates alive and away spells
    of geometric length (mean ``1/rate`` rounds) from a seeded phase: a
    random-telegraph picture of Poisson arrivals and departures, half
    the population alive on average.
  * ``"lifetime:mean[,stagger]"`` — client ``j`` arrives at a seeded
    round in ``[0, stagger]`` (default 0), stays an exponential(mean)
    number of rounds, and leaves for good.

The per-id draws come from one function, ``_per_id_uniforms``: the
port's counter draw (``repro_torch.comm.channel._unit``, a pure function
of (salt, id, lane)), not the reference's threefry stream, so the same
seed gives other lifetimes than ``repro``; same distributions.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.comm.channel import _unit

CHURN_KINDS = ("step", "poisson", "lifetime")

# crc32 tag separating churn draws from channel-field streams that may
# share a DynamicsConfig seed
_CHURN_TAG = zlib.crc32(b"repro.dynamics.churn")


def _per_id_uniforms(n_streams: int, seed: int, m: int) -> np.ndarray:
    """(m, n_streams) float64 U[0,1) per-id draws of one churn seed:
    client j's row is a pure function of (seed, j)."""
    salt = (_CHURN_TAG ^ (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    ids = np.arange(m, dtype=np.int64)
    return np.stack([_unit(salt, ids, lane) for lane in range(n_streams)],
                    axis=1)


class ChurnProcess:
    """Base: deterministic eligibility as a function of ``(t, id)``.

    Subclasses implement ``_alive_params(m) -> tuple[np.ndarray, ...]``
    (cached per population size) and ``_alive(params, ids, t)``.
    """

    seed: int = 0

    def __init__(self):
        self._cache: "dict[int, tuple]" = {}

    def _alive_params(self, m: int) -> tuple:
        raise NotImplementedError

    def _alive(self, params: tuple, ids: np.ndarray, t: int) -> np.ndarray:
        raise NotImplementedError

    def _params(self, m: int) -> tuple:
        if m not in self._cache:
            self._cache[m] = self._alive_params(m)
        return self._cache[m]

    def alive(self, ids, t: int, m: int) -> np.ndarray:
        """(len(ids),) bool: is each client alive at round ``t``?"""
        ids = np.asarray(ids, dtype=np.int64)
        return self._alive(self._params(m), ids, t)

    def eligible_mask(self, t: int, m: int) -> np.ndarray:
        """(m,) bool eligibility at round ``t``."""
        return self.alive(np.arange(m, dtype=np.int64), t, m)

    def eligible_ids(self, t: int, m: int) -> np.ndarray:
        """Sorted int64 ids of the clients alive at round ``t``."""
        return np.nonzero(self.eligible_mask(t, m))[0].astype(np.int64)


@dataclasses.dataclass(eq=False)
class StepChurn(ChurnProcess):
    """A seeded ``frac``-fraction departs for good at round ``t0``."""

    t0: int = 1
    frac: float = 0.5
    seed: int = 0

    def __post_init__(self):
        super().__init__()
        if self.t0 < 0:
            raise ValueError(f"step churn t must be >= 0, got {self.t0}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(
                f"step churn frac must be in [0, 1], got {self.frac}")

    def _alive_params(self, m):
        u = _per_id_uniforms(1, self.seed, m)
        return (u[:, 0] < self.frac,)  # the departing set

    def _alive(self, params, ids, t):
        (departing,) = params
        if t < self.t0:
            return np.ones(len(ids), dtype=bool)
        return ~departing[ids]


@dataclasses.dataclass(eq=False)
class PoissonChurn(ChurnProcess):
    """Random-telegraph membership: alternating alive and away spells of
    geometric(rate) length from a seeded phase per client."""

    rate: float = 0.05
    seed: int = 0

    def __post_init__(self):
        super().__init__()
        if not 0.0 < self.rate < 1.0:
            raise ValueError(
                f"poisson churn rate must be in (0, 1), got {self.rate}")

    def _alive_params(self, m):
        u = _per_id_uniforms(3, self.seed, m)
        # inverse-CDF geometric spell lengths (>= 1 round each)
        log1p = np.log1p(-self.rate)
        up = 1 + np.floor(np.log(1.0 - u[:, 0]) / log1p).astype(np.int64)
        down = 1 + np.floor(np.log(1.0 - u[:, 1]) / log1p).astype(np.int64)
        phase = np.floor(u[:, 2] * (up + down)).astype(np.int64)
        return up, down, phase

    def _alive(self, params, ids, t):
        up, down, phase = params
        period = up[ids] + down[ids]
        return ((t + phase[ids]) % period) < up[ids]


@dataclasses.dataclass(eq=False)
class LifetimeChurn(ChurnProcess):
    """Exponential(mean) lifetimes with arrivals staggered over
    ``[0, stagger]`` rounds; departed clients never return."""

    mean: float = 20.0
    stagger: int = 0
    seed: int = 0

    def __post_init__(self):
        super().__init__()
        if self.mean <= 0:
            raise ValueError(
                f"lifetime churn mean must be > 0, got {self.mean}")
        if self.stagger < 0:
            raise ValueError(
                f"lifetime churn stagger must be >= 0, got {self.stagger}")

    def _alive_params(self, m):
        u = _per_id_uniforms(2, self.seed, m)
        arrival = np.floor(u[:, 0] * (self.stagger + 1)).astype(np.int64)
        life = np.maximum(
            1, np.ceil(-self.mean * np.log(1.0 - u[:, 1]))).astype(np.int64)
        return arrival, life

    def _alive(self, params, ids, t):
        arrival, life = params
        a = arrival[ids]
        return (a <= t) & (t < a + life[ids])


def make_churn(spec: "str | ChurnProcess", seed: int = 0) -> ChurnProcess:
    """Parse a churn spec (see the module docstring) or pass one through."""
    if isinstance(spec, ChurnProcess):
        return spec
    kind, _, rest = str(spec).partition(":")
    known = ", ".join(k + ":..." for k in CHURN_KINDS)
    if kind not in CHURN_KINDS:
        raise ValueError(
            f"unknown churn spec {spec!r}; expected one of {known}")
    parts = [p.strip() for p in rest.split(",") if p.strip()]
    try:
        if kind == "step":
            kv = {"frac": 0.5}
            pos = []
            for p in parts:
                k, eq, v = p.partition("=")
                if eq:
                    kv[k.strip()] = float(v)
                else:
                    pos.append(float(p))
            if pos:
                kv["t"] = pos[0]
                if len(pos) > 1:
                    kv["frac"] = pos[1]
            return StepChurn(t0=int(kv["t"]), frac=float(kv["frac"]),
                             seed=seed)
        if kind == "poisson":
            return PoissonChurn(rate=float(parts[0]), seed=seed)
        mean = float(parts[0])
        stagger = int(float(parts[1])) if len(parts) > 1 else 0
        return LifetimeChurn(mean=mean, stagger=stagger, seed=seed)
    except (KeyError, IndexError, ValueError) as e:
        if isinstance(e, ValueError) and e.args and "churn" in str(e):
            raise
        raise ValueError(
            f"bad parameters in churn spec {spec!r} ({e!r}); expected "
            f"'step:t=T[,frac=f]', 'poisson:rate', or "
            f"'lifetime:mean[,stagger]'") from e
