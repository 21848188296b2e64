"""Per-client link model: bandwidth, latency, compute, stragglers, dropout.

Counterpart of ``repro.comm.channel`` for the dense (m,) client axis
(the per-cohort ``*_for`` views come with the populations slice). The
channel is a host-side numpy model: per round it draws which clients
straggle (slowed by ``straggler_slowdown``) and which drop out, then turns
per-client byte counts into per-client cycle times (``client_times`` =
latency + broadcast download + local compute + upload); the synchronous
round waits for the slowest delivering client (``round_time``).

Per-client fields (``uplink_bytes_per_s`` / ``downlink_bytes_per_s`` /
``latency_s`` / ``compute_s``) accept a scalar, an ``(m,)`` array, or a
distribution spec string (``"loguniform:lo,hi"``, ``"lognormal:median,
sigma"``, ``"uniform:lo,hi"``, ``"const:v"``) drawn per client id from a
field-keyed stream (``attr_seed`` and the field name), so client j's
value is a pure function of the spec and j. The port draws those values
with its own counter-based generator, not JAX's: same distributions,
other numbers.

The round coins come from one host key (``draw``), so a trajectory is
exactly reproducible from ``(CommConfig.seed, round index)``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.keys import generator

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
    """U[0,1) per id, a pure function of (salt, lane, id)."""
    with np.errstate(over="ignore"):
        z = _mix(_mix(np.full(ids.shape, (salt << 8) | lane, np.uint64))
                 ^ ids.astype(np.uint64))
    return (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


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

    def _field(self, name: str, m: int) -> np.ndarray:
        return _per_client(getattr(self, name), m, field=name,
                           seed=self.attr_seed)

    def uplink_rates(self, m: int) -> np.ndarray:
        return self._field("uplink_bytes_per_s", m)

    def downlink_rates(self, m: int) -> np.ndarray:
        return self._field("downlink_bytes_per_s", m)

    def compute_times(self, m: int) -> np.ndarray:
        return self._field("compute_s", m)

    def latencies(self, m: int) -> np.ndarray:
        return self._field("latency_s", m)

    def draw(self, key: torch.Tensor, m: int) -> ChannelDraw:
        """The round's straggler and dropout coins, from one host key."""
        coins = torch.rand((2, m), generator=generator(key, "cpu"),
                           dtype=torch.float64).numpy()
        return ChannelDraw(straggler=coins[0] < self.straggler_prob,
                           dropout=coins[1] < self.dropout_prob)

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
