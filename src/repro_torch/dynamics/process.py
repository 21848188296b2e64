"""Time-varying channels: a process wrapper over ``ChannelModel``.

Counterpart of ``repro.dynamics.process``. ``ChannelModel`` draws
static per-client link values; a ``ChannelProcess`` modulates them per
round with deterministic per-field multipliers and overlays correlated
regional outages. Every value is a pure function of ``(field,
client_id, round)`` and the process seed: O(1) storage at any
population size, the same in every driver and at any cohort
composition.

Multiplier spec grammar (``"+"``-chained, applied left to right):

  * ``"sin:period,amp"`` — diurnal cycle ``1 + amp*sin(2*pi*(t+phi_j)/
    period)`` with a seeded per-client phase ``phi_j`` in ``[0,
    period)``;
  * ``"drift:rate"`` — monotone drift ``exp(+/-rate * t)`` with a seeded
    per-client direction (half the links improve, half degrade).

Multipliers are clipped to ``[0.05, 20]`` so a deep trough never zeroes
a bandwidth. The multiplier scales the field's value whatever its unit:
a bandwidth below 1x is slower, a latency or compute time above 1x is
slower.

Outages (``outage="outage:p,dur[,groups]"``): time is cut into windows
of ``dur`` rounds; in each window each of ``groups`` regions (client
``j``'s region is ``j % groups``, 8 by default) goes dark with
probability ``p``, and every member of a dark region drops: a
correlated failure no iid dropout coin reproduces.

The per-id draws (a sin stage's phase, a drift stage's sign) come from
``_stage_draws`` and an outage window's coins from ``_outage_window``,
both on the port's counter draw (``repro_torch.comm.channel._unit``),
not the reference's threefry streams; the multiplier itself is computed
from those draws in float64 numpy.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np

from repro_torch.comm.channel import ChannelDraw, _unit

MODULATOR_KINDS = ("sin", "drift")

MULT_MIN, MULT_MAX = 0.05, 20.0

_FIELDS = ("uplink_bytes_per_s", "downlink_bytes_per_s", "latency_s",
           "compute_s")

_OUTAGE_TAG = zlib.crc32(b"repro.dynamics.outage")


def _parse_modulator(spec: str) -> "tuple[tuple[str, tuple[float, ...]], ...]":
    """Parse a ``"+"``-chained multiplier spec into (kind, params) stages."""
    stages = []
    known = ", ".join(k + ":..." for k in MODULATOR_KINDS)
    for part in str(spec).split("+"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        if kind not in MODULATOR_KINDS:
            raise ValueError(
                f"unknown channel modulator {part!r} in {spec!r}; "
                f"expected one of {known}")
        try:
            params = tuple(float(p) for p in rest.split(",") if p != "")
        except ValueError:
            raise ValueError(
                f"bad parameters in channel modulator {part!r} (spec "
                f"{spec!r}); expected {known}") from None
        want = 2 if kind == "sin" else 1
        if len(params) != want:
            raise ValueError(
                f"channel modulator {part!r} wants {want} parameter(s), "
                f"got {len(params)} (spec {spec!r})")
        if kind == "sin" and params[0] <= 0:
            raise ValueError(
                f"sin modulator period must be > 0 in {part!r}")
        stages.append((kind, params))
    if not stages:
        raise ValueError(
            f"empty channel modulator spec {spec!r}; expected one of {known}")
    return tuple(stages)


def _stage_draws(spec: str, salt: int, ids: np.ndarray) -> "list[np.ndarray]":
    """Per stage of ``spec``, the (len(ids),) per-id draw: a sin stage's
    phase in ``[0, period)``, a drift stage's sign (+1 or -1). Pure in
    ``(spec, salt, stage, id)``; ``salt`` is below 2^32."""
    out = []
    for i, (kind, params) in enumerate(_parse_modulator(spec)):
        u = _unit((salt << 8) | i, ids, 0)
        out.append(u * params[0] if kind == "sin"
                   else np.where(u < 0.5, 1.0, -1.0))
    return out


def _parse_outage(spec: str) -> "tuple[float, int, int]":
    kind, _, rest = str(spec).partition(":")
    if kind != "outage":
        raise ValueError(
            f"unknown outage spec {spec!r}; expected "
            f"'outage:p,dur[,groups]'")
    try:
        params = tuple(float(p) for p in rest.split(",") if p != "")
    except ValueError:
        raise ValueError(
            f"bad parameters in outage spec {spec!r}; expected "
            f"'outage:p,dur[,groups]'") from None
    if len(params) not in (2, 3):
        raise ValueError(
            f"outage spec {spec!r} wants 2-3 parameters (p, dur[, groups]), "
            f"got {len(params)}")
    p, dur = params[0], int(params[1])
    groups = int(params[2]) if len(params) == 3 else 8
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"outage probability must be in [0, 1], got {p}")
    if dur < 1 or groups < 1:
        raise ValueError(
            f"outage duration and group count must be >= 1 in {spec!r}")
    return p, dur, groups


@functools.lru_cache(maxsize=4096)
def _outage_window(p: float, groups: int, salt: int, window: int) -> tuple:
    """Which regions are dark in one outage window (seeded, correlated):
    a tuple of ``groups`` bools, pure in ``(p, salt, window)``."""
    window_salt = (salt << 24) | (window & 0xFFFFFF)
    dark = _unit(window_salt, np.arange(groups, dtype=np.int64), 0) < p
    return tuple(bool(b) for b in dark)


@dataclasses.dataclass(frozen=True)
class ChannelProcess:
    """Deterministic round-indexed modulation of a ``ChannelModel``.

    Field attributes take multiplier specs (see the module docstring) or
    ``None`` (field untouched); ``outage`` takes an outage spec or
    ``None``. ``at(base, t)`` returns a view with ``ChannelModel``'s
    draw and time methods bound to round ``t``: the sessions take it per
    round, so the base model stays static.
    """

    uplink_bytes_per_s: "str | None" = None
    downlink_bytes_per_s: "str | None" = None
    latency_s: "str | None" = None
    compute_s: "str | None" = None
    outage: "str | None" = None
    seed: int = 0

    def __post_init__(self):
        # every spec parses here: bad grammar fails at config time
        for field in _FIELDS:
            spec = getattr(self, field)
            if spec is not None:
                _parse_modulator(spec)
        if self.outage is not None:
            _parse_outage(self.outage)

    @property
    def has_outage(self) -> bool:
        return self.outage is not None

    def multiplier(self, field: str, ids, t: int) -> np.ndarray:
        """(len(ids),) float64 modulation of ``field`` at round ``t``,
        pure in ``(field, seed, id, round)``."""
        spec = getattr(self, field)
        ids = np.asarray(ids, dtype=np.int64)
        if spec is None:
            return np.ones(len(ids), dtype=np.float64)
        salt = (zlib.crc32(field.encode()) ^ (self.seed & 0xFFFFFFFF)) \
            & 0xFFFFFFFF
        t = float(t)
        mult = np.ones(len(ids), dtype=np.float64)
        for (kind, params), draw in zip(_parse_modulator(spec),
                                        _stage_draws(str(spec), salt, ids)):
            if kind == "sin":
                period, amp = params
                mult = mult * (1.0 + amp * np.sin(
                    2.0 * np.pi * (t + draw) / period))
            else:  # drift
                (rate,) = params
                mult = mult * np.exp(draw * rate * t)
        return np.clip(mult, MULT_MIN, MULT_MAX)

    def outage_mask(self, ids, t: int) -> np.ndarray:
        """(len(ids),) bool: is each client's region dark at round ``t``?"""
        ids = np.asarray(ids, dtype=np.int64)
        if self.outage is None:
            return np.zeros(len(ids), dtype=bool)
        p, dur, groups = _parse_outage(self.outage)
        salt = (_OUTAGE_TAG ^ (self.seed & 0xFFFFFFFF)) & 0xFFFFFFFF
        dark = np.asarray(
            _outage_window(p, groups, salt, int(t) // dur), dtype=bool)
        return dark[ids % groups]

    def at(self, base, t: int) -> "RoundChannel":
        """The channel as seen at round ``t`` (a ``ChannelModel``-shaped
        view over ``base``)."""
        return RoundChannel(base, self, int(t))


class RoundChannel:
    """One round's view of a modulated channel.

    Has every method of ``ChannelModel`` the sessions and schedulers
    call (``draw`` / ``draw_for``, ``client_times`` /
    ``client_times_for``, ``round_time`` / ``round_time_for``, the rate
    views and their cohort forms), with the same signatures: the
    process's multipliers scale the base model's fields and regional
    outages are OR-ed into the dropout coins. ``CommConfig.channel_at``
    keeps the latest round's view, and the view keeps its dense (m,)
    fields: the asynchronous driver prices every dispatch and
    re-dispatch of a version on the whole client axis.
    """

    def __init__(self, base, process: ChannelProcess, t: int):
        self._base = base
        self._process = process
        self._t = t
        self._dense: "dict[tuple[str, int], np.ndarray]" = {}

    def _field(self, name: str, ids, m: int) -> np.ndarray:
        if ids is not None:
            return (self._base._field(name, ids, m)
                    * self._process.multiplier(name, ids, self._t))
        if (name, m) not in self._dense:
            self._dense[name, m] = self._base._field(name, None, m) * \
                self._process.multiplier(name, np.arange(m), self._t)
        return self._dense[name, m]

    # -- rate views (BandwidthAware samples on the modulated rates) ---------
    def uplink_rates(self, m: int) -> np.ndarray:
        return self._field("uplink_bytes_per_s", None, m)

    def downlink_rates(self, m: int) -> np.ndarray:
        return self._field("downlink_bytes_per_s", None, m)

    def compute_times(self, m: int) -> np.ndarray:
        return self._field("compute_s", None, m)

    def latencies(self, m: int) -> np.ndarray:
        return self._field("latency_s", None, m)

    def uplink_rates_for(self, ids, m: int) -> np.ndarray:
        return self._field("uplink_bytes_per_s", ids, m)

    def downlink_rates_for(self, ids, m: int) -> np.ndarray:
        return self._field("downlink_bytes_per_s", ids, m)

    def compute_times_for(self, ids, m: int) -> np.ndarray:
        return self._field("compute_s", ids, m)

    def latencies_for(self, ids, m: int) -> np.ndarray:
        return self._field("latency_s", ids, m)

    # -- coins ---------------------------------------------------------------
    def _with_outage(self, draw: ChannelDraw, ids) -> ChannelDraw:
        if not self._process.has_outage:
            return draw
        out = self._process.outage_mask(ids, self._t)
        return dataclasses.replace(draw, dropout=draw.dropout | out)

    def draw(self, key, m: int) -> ChannelDraw:
        return self._with_outage(self._base.draw(key, m),
                                 np.arange(m, dtype=np.int64))

    def draw_for(self, key, ids) -> ChannelDraw:
        return self._with_outage(self._base.draw_for(key, ids),
                                 np.asarray(ids, dtype=np.int64))

    # -- times ---------------------------------------------------------------
    def client_times(self, draw, bytes_up, bytes_down) -> np.ndarray:
        m = draw.straggler.shape[0]
        t = (self.latencies(m) + bytes_down / self.downlink_rates(m)
             + self.compute_times(m) + bytes_up / self.uplink_rates(m))
        return np.where(draw.straggler, t * self._base.straggler_slowdown, t)

    def client_times_for(self, ids, m, draw, bytes_up,
                         bytes_down) -> np.ndarray:
        t = (self.latencies_for(ids, m)
             + bytes_down / self.downlink_rates_for(ids, m)
             + self.compute_times_for(ids, m)
             + bytes_up / self.uplink_rates_for(ids, m))
        return np.where(draw.straggler, t * self._base.straggler_slowdown, t)

    def round_time(self, draw, delivered, bytes_up, bytes_down) -> float:
        t = self.client_times(draw, bytes_up, bytes_down)
        if not delivered.any():
            return float(np.mean(self.latencies(draw.straggler.shape[0])))
        return float(np.max(t[delivered]))

    def round_time_for(self, ids, m, draw, delivered, bytes_up,
                       bytes_down) -> float:
        if not delivered.any():
            lat = self.latencies_for(ids, m)
            return float(np.mean(lat)) if len(lat) else 0.0
        t = self.client_times_for(ids, m, draw, bytes_up, bytes_down)
        return float(np.max(t[delivered]))
