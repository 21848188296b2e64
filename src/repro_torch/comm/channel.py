"""Per-client link model: bandwidth, latency, compute, stragglers, dropout.

Counterpart of ``repro.comm.channel``. The channel is a host-side numpy
model: per round it draws which clients straggle (slowed by
``straggler_slowdown``) and which drop out, then turns per-client byte
counts into per-client cycle times (``client_times`` = latency +
broadcast download + local compute + upload). The synchronous round
waits for the slowest delivering client (``round_time``); the
asynchronous driver keeps the per-client vector as its event clock.
The ``*_for`` views serve a cohort of client ids drawn from a population
of m clients without any (m,) array.

Per-client fields (``uplink_bytes_per_s`` / ``downlink_bytes_per_s`` /
``latency_s`` / ``compute_s``) accept a scalar, an ``(m,)`` array, or a
distribution spec string (``"loguniform:lo,hi"``, ``"lognormal:median,
sigma"``, ``"uniform:lo,hi"``, ``"const:v"``) drawn per client id from a
field-keyed stream (``attr_seed`` and the field name), so client j's
value is a pure function of the spec and j. The port draws those values
with its own counter-based generator, not JAX's: same distributions,
other numbers.

The round coins come from one host key: ``draw`` for the dense axis,
``draw_for`` per client id (client j's coins are a pure function of the
key and j, whatever the cohort), so a trajectory is exactly reproducible
from ``(CommConfig.seed, round index)``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.keys import generator, key_bits

FIELD_DISTRIBUTIONS = ("loguniform", "lognormal", "uniform", "const")

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _parse_spec(spec: str) -> "tuple[str, tuple[float, ...]]":
    kind, _, rest = spec.partition(":")
    if kind not in FIELD_DISTRIBUTIONS:
        raise ValueError(
            f"unknown channel distribution {spec!r}; expected one of "
            f"{', '.join(k + ':...' for k in FIELD_DISTRIBUTIONS)}")
    try:
        params = tuple(float(p) for p in rest.split(",") if p != "")
    except ValueError:
        raise ValueError(f"bad parameters in channel distribution {spec!r}")
    want = 1 if kind == "const" else 2
    if len(params) != want:
        raise ValueError(
            f"channel distribution {spec!r} wants {want} parameter(s), "
            f"got {len(params)}")
    return kind, params


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over a uint64 array (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _unit(salt: int, ids: np.ndarray, lane: int) -> np.ndarray:
    """U[0,1) per id, a pure function of (salt, lane, id); ``salt`` is
    any integer below 2^56."""
    with np.errstate(over="ignore"):
        z = _mix(_mix(np.full(ids.shape, (salt << 8) | lane, np.uint64))
                 ^ ids.astype(np.uint64))
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def _key_salt(key: torch.Tensor) -> int:
    """A host key folded to the 56 bits ``_unit`` takes as its salt."""
    bits = key_bits(key)
    return (bits ^ (bits >> 56)) & ((1 << 56) - 1)


def _draw_spec(spec: str, ids: np.ndarray, field: str, seed: int) -> np.ndarray:
    kind, params = _parse_spec(spec)
    salt = (zlib.crc32(field.encode()) ^ (seed & 0xFFFFFFFF)) & 0xFFFFFFFF
    ids = np.asarray(ids, dtype=np.int64)
    if kind == "const":
        return np.full(ids.shape, params[0], dtype=np.float64)
    u = _unit(salt, ids, 0)
    if kind == "uniform":
        lo, hi = params
        return lo + (hi - lo) * u
    if kind == "loguniform":
        lo, hi = params
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    median, sigma = params
    normal = (np.sqrt(-2.0 * np.log1p(-u))
              * np.cos(2.0 * np.pi * _unit(salt, ids, 1)))
    return median * np.exp(sigma * normal)


def _per_client(x, m: int, field: str = "per-client value",
                seed: int = 0) -> np.ndarray:
    """Resolve a channel field to a float64 ``(m,)`` vector: scalars
    broadcast, distribution specs draw per client id, arrays must already
    be ``(m,)``."""
    if isinstance(x, str):
        return _draw_spec(x, np.arange(m), field, seed)
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim == 0:
        return np.full((m,), float(arr))
    if arr.shape != (m,):
        raise ValueError(
            f"channel field {field!r} has shape {arr.shape}, want ({m},) "
            f"— pass a scalar, an (m,) array, or a distribution spec "
            f"like 'loguniform:lo,hi'")
    return arr


@dataclasses.dataclass(frozen=True)
class ChannelDraw:
    """One round's channel randomness for the scheduled cohort."""

    straggler: np.ndarray  # (m,) bool
    dropout: np.ndarray  # (m,) bool


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Synchronous-round link model (fields as the module docstring says)."""

    uplink_bytes_per_s: "float | np.ndarray | str" = 1.25e6  # ~10 Mbit/s up
    downlink_bytes_per_s: "float | np.ndarray | str" = 1.25e7  # ~100 Mbit/s
    latency_s: "float | np.ndarray | str" = 0.05
    compute_s: "float | np.ndarray | str" = 0.0  # per-client local compute
    straggler_prob: float = 0.0
    straggler_slowdown: float = 10.0
    dropout_prob: float = 0.0
    attr_seed: int = 0  # stream seed for distribution-spec fields

    # -- dense (m,) views ----------------------------------------------------
    def _field(self, name: str, ids: "np.ndarray | None", m: int) -> np.ndarray:
        """Values of one field for ``ids`` (None: all m clients)."""
        x = getattr(self, name)
        if ids is None:
            return _per_client(x, m, field=name, seed=self.attr_seed)
        ids = np.asarray(ids, dtype=np.int64)
        if isinstance(x, str):
            return _draw_spec(x, ids, name, self.attr_seed)
        arr = np.asarray(x, dtype=np.float64)
        if arr.ndim == 0:
            return np.full((len(ids),), float(arr))
        if arr.shape != (m,):
            raise ValueError(
                f"channel field {name!r} has shape {arr.shape}, want ({m},) "
                f"— pass a scalar, an (m,) array over the population, or a "
                f"distribution spec like 'loguniform:lo,hi'")
        return arr[ids]

    def uplink_rates(self, m: int) -> np.ndarray:
        return self._field("uplink_bytes_per_s", None, m)

    def downlink_rates(self, m: int) -> np.ndarray:
        return self._field("downlink_bytes_per_s", None, m)

    def compute_times(self, m: int) -> np.ndarray:
        return self._field("compute_s", None, m)

    def latencies(self, m: int) -> np.ndarray:
        return self._field("latency_s", None, m)

    # -- cohort views (populations) -------------------------------------------
    def uplink_rates_for(self, ids, m: int) -> np.ndarray:
        """(c,) uplink rates of the cohort ``ids`` of an m-client
        population (per id for spec fields)."""
        return self._field("uplink_bytes_per_s", ids, m)

    def downlink_rates_for(self, ids, m: int) -> np.ndarray:
        return self._field("downlink_bytes_per_s", ids, m)

    def compute_times_for(self, ids, m: int) -> np.ndarray:
        return self._field("compute_s", ids, m)

    def latencies_for(self, ids, m: int) -> np.ndarray:
        return self._field("latency_s", ids, m)

    def draw(self, key: torch.Tensor, m: int) -> ChannelDraw:
        """The round's straggler and dropout coins, from one host key."""
        coins = torch.rand((2, m), generator=generator(key, "cpu"),
                           dtype=torch.float64).numpy()
        return ChannelDraw(straggler=coins[0] < self.straggler_prob,
                           dropout=coins[1] < self.dropout_prob)

    def draw_for(self, key: torch.Tensor, ids) -> ChannelDraw:
        """Cohort coins keyed per client id: client j's coins depend on
        (key, j) only, never on which other clients ride the cohort, so
        drivers sampling one cohort from one round key see the same
        coins. Counter-based (``_unit``): no generator per client."""
        ids = np.asarray(ids, dtype=np.int64)
        salt = _key_salt(key)
        return ChannelDraw(
            straggler=_unit(salt, ids, 0) < self.straggler_prob,
            dropout=_unit(salt, ids, 1) < self.dropout_prob)

    def client_times(
        self,
        draw: ChannelDraw,
        bytes_up: np.ndarray,  # (m,) uplink bytes per client
        bytes_down: np.ndarray,  # (m,) broadcast bytes per client
    ) -> np.ndarray:
        """(m,) per-client cycle times: latency + downlink + compute +
        uplink, straggler-scaled."""
        m = draw.straggler.shape[0]
        up = self.uplink_rates(m)
        down = self.downlink_rates(m)
        t = (self.latencies(m) + bytes_down / down + self.compute_times(m)
             + bytes_up / up)
        return np.where(draw.straggler, t * self.straggler_slowdown, t)

    def client_times_for(self, ids, m: int, draw: ChannelDraw,
                         bytes_up: np.ndarray,
                         bytes_down: np.ndarray) -> np.ndarray:
        """(c,) cycle times of the cohort ``ids`` of an m-client
        population, from its cohort-length coins (``draw_for``)."""
        up = self.uplink_rates_for(ids, m)
        down = self.downlink_rates_for(ids, m)
        t = (self.latencies_for(ids, m) + bytes_down / down
             + self.compute_times_for(ids, m) + bytes_up / up)
        return np.where(draw.straggler, t * self.straggler_slowdown, t)

    def round_time(
        self,
        draw: ChannelDraw,
        delivered: np.ndarray,  # (m,) bool — scheduled & not dropped
        bytes_up: np.ndarray,  # (m,) uplink bytes for delivering clients
        bytes_down: np.ndarray,  # (m,) broadcast bytes per client
    ) -> float:
        """Simulated wall-clock: the slowest delivering client closes the
        round."""
        t = self.client_times(draw, bytes_up, bytes_down)
        if not delivered.any():
            # empty round still costs a propagation delay
            return float(np.mean(self.latencies(draw.straggler.shape[0])))
        return float(np.max(t[delivered]))

    def round_time_for(self, ids, m: int, draw: ChannelDraw,
                       delivered: np.ndarray, bytes_up: np.ndarray,
                       bytes_down: np.ndarray) -> float:
        """A cohort round's simulated wall-clock (populations)."""
        if not delivered.any():
            lat = self.latencies_for(ids, m)
            return float(np.mean(lat)) if len(lat) else 0.0
        t = self.client_times_for(ids, m, draw, bytes_up, bytes_down)
        return float(np.max(t[delivered]))
