"""CommConfig and the per-round objects the synchronous driver threads.

Counterpart of ``repro.comm.config``:

  * ``CommConfig``  — which codec per payload name *and direction*, which
      participation scheduler, which channel model, error feedback, seed,
      and the asynchronous driver's settings (``async_mode``,
      ``buffer_size``, ``async_quantile``, ``staleness``, ``server_lr``).
  * ``CommSession`` — host-side state of one synchronous trajectory:
      draws cohorts and channel coins per round, runs the round,
      accumulates ``RoundTrace``s, and owns the payload byte plan (exact
      encoded bytes per payload occurrence, recorded on each round
      variant's first executed round; payload shapes are static per
      variant). ``PopulationCommSession`` is its counterpart over a
      ``ClientPopulation``: per round it samples cohort ids,
      materializes them, draws coins per id and keeps EF rows in a
      bounded hot set.
  * ``CommRound``   — the view the optimizer's round sees:
      ``uplink(name, x)`` routes a stacked per-client payload through its
      codec, ``downlink(name, x)`` routes a server broadcast through its
      ``"down:"`` codec (encoded once, billed per scheduled client), and
      ``weights(p)`` masks and renormalizes aggregation weights for the
      delivering cohort.

With ``CommConfig(error_feedback=...)`` lossy EF-eligible uplinks carry
client memory (``repro_torch.comm.feedback``): ``uplink`` folds it in
and writes the new memory to ``CommRound.memory_out``.

Randomness. Each draw happens in one method a caller can replace: the
cohort in ``Scheduler.participants``, the straggler and dropout coins in
``ChannelModel.draw``, and the codec noise of each lossy payload
occurrence in ``CommRound.codec_noise``. The port's own draws use seeded
``torch.Generator``s: cohort and coins on the host from
``(seed, round, stream)``, codec noise on the payload's device from the
round's codec key and the payload counter (uplinks count from 1, the
downlink on the disjoint stream ``_DOWNLINK_KEY_STREAM + i``).

Bit-exactness: with identity codecs and full participation (no dropout)
``uplink`` and ``downlink`` return their input objects and ``weights``
returns ``p``, so the trajectory is bit-identical to ``comm=None``.

Scenario dynamics (``CommConfig(dynamics=DynamicsConfig(...))``, see
``repro_torch.dynamics``) compose on top: churn filters the eligible ids
the scheduler samples from (departed clients' EF rows are retired), a
``ChannelProcess`` modulates the channel per round (``channel_at``), a
``ThreatModel`` corrupts a seeded subset of uplinks inside the round,
before the codec, and a robust aggregator transforms the decoded
payload before the optimizer's weighted aggregation. Its counters go to
``CommRound.stats_out`` as device scalars, which the session reads once
a round. With ``dynamics=None`` every code path here is the one without
dynamics.

The asynchronous drivers live in ``repro_torch.comm.async_driver``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.comm import feedback
from repro_torch.comm.channel import ChannelModel
from repro_torch.comm.codecs import Codec, IdentityCodec, make_codec
from repro_torch.comm.metrics import RoundTrace, Transport, transport_from_traces
from repro_torch.comm.scheduler import Scheduler, make_scheduler
from repro_torch.device import host_to, resolve_device
from repro_torch.keys import generator, key_bits, key_from_ints
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.obs import log as obs_log

# payload-name prefix that selects the downlink (server -> client)
# direction in codec specs and in the byte plan
DOWN = "down:"

# control-plane payloads default to lossless whatever the default codec
# (compressing a 1-scalar guard loss or the sketch seed saves nothing and
# can poison the accept/reject logic or the shared basis)
_LOSSLESS_BY_DEFAULT = ("loss", "down:seed")

# noise stream offset separating downlink payloads from the uplink
# payload counter
_DOWNLINK_KEY_STREAM = 1 << 20

# noise stream offset of the threat model's corruption draws (disjoint
# from the uplink counter and the downlink stream, so turning a threat
# on never changes codec noise)
_THREAT_KEY_STREAM = 1 << 21

# the per-round host keys: cohort, channel coins, codec noise
_SCHED_STREAM, _CHAN_STREAM, _CODEC_STREAM = 0, 1, 2

# begin_variant sentinel: "no variant announced yet" (None is a valid
# round signature)
_NO_VARIANT = object()


def round_keys(seed: int, t: int):
    """Round (or model version) ``t``'s host keys: (cohort, channel
    coins, codec noise). Every driver shares this schedule, so sync and
    async runs of one seed draw the same cohorts and coins."""
    return (key_from_ints(seed, t, _SCHED_STREAM),
            key_from_ints(seed, t, _CHAN_STREAM),
            key_from_ints(seed, t, _CODEC_STREAM))


def plan_bytes(plan: "Dict[str, int]", *, down: bool) -> int:
    """Sum one direction of a payload byte plan (keys are payload
    occurrences; downlink occurrences carry the ``"down:"`` prefix)."""
    return int(sum(v for k, v in plan.items()
                   if k.startswith(DOWN) == down))


@dataclasses.dataclass
class CommConfig:
    """Transport description for one federated run.

    ``codecs`` maps payload names (``"h_sk"``, ``"sg"``, ``"grad"``, ...)
    to codec specs; the ``"default"`` entry covers unnamed payloads, and a
    bare string or Codec is shorthand for ``{"default": ...}``. Downlink
    payloads resolve under ``"down:<name>"``, then ``"down:default"``,
    then identity, never the uplink default. ``downlink_codecs`` merges
    into ``codecs`` with the prefix applied (explicit ``down:`` entries
    win).

    ``error_feedback``: ``True`` (every eligible lossy payload), a
    collection of payload names, or a ``{name: bool}`` dict with an
    optional ``"default"``; ``ef_variant`` is ``"ef21"`` or ``"ef14"``.
    ``ef_capacity`` bounds EF state over a ``ClientPopulation``: rows are
    kept for an LRU hot set of that many ids (default ``min(m, 8 x
    cohort size)``); dense runs ignore it.

    ``async_mode=True`` selects the event-driven asynchronous driver
    (``repro_torch.comm.async_driver``): the server commits once a quorum
    has arrived, ``buffer_size`` uploads when set, else
    ``ceil(async_quantile * m)``. ``staleness`` weights stale
    contributions (``"constant"``, ``"inverse"``, ``"poly:a"`` or a
    callable; ``make_staleness``), and ``server_lr`` scales every
    committed delta after it (an async control: with ``async_mode=False``
    it raises). With the full scheduler, no dropout, a full quorum and
    ``server_lr=1`` the async driver reproduces the synchronous
    trajectory bit for bit. ``dynamics`` takes a
    ``repro_torch.dynamics.DynamicsConfig`` (churn, a channel process, a
    threat, robust aggregation); an all-``None`` one normalizes to
    ``None``.
    """

    codecs: "Dict[str, Any] | str | Codec" = "identity"
    downlink_codecs: "Dict[str, Any] | str | Codec | None" = None
    scheduler: "str | Scheduler" = "full"
    channel: ChannelModel = dataclasses.field(default_factory=ChannelModel)
    seed: int = 0
    error_feedback: "bool | str | Dict[str, bool] | tuple | frozenset" = False
    ef_variant: str = "ef21"
    ef_capacity: "int | None" = None  # EF hot-set size (populations)
    async_mode: bool = False
    buffer_size: "int | None" = None
    async_quantile: float = 1.0
    staleness: "str | Any" = "constant"
    server_lr: float = 1.0
    dynamics: "Any | None" = None

    def __post_init__(self):
        if self.dynamics is not None:
            from repro_torch.dynamics import DynamicsConfig

            if not isinstance(self.dynamics, DynamicsConfig):
                raise ValueError(
                    f"CommConfig.dynamics wants a "
                    f"repro_torch.dynamics.DynamicsConfig, got "
                    f"{self.dynamics!r}")
            if self.dynamics.is_null:
                # all layers off: every `dynamics is None` path holds
                self.dynamics = None
        if self.server_lr <= 0.0:
            raise ValueError(f"server_lr must be > 0, got {self.server_lr}")
        if self.server_lr != 1.0 and not self.async_mode:
            raise ValueError(
                "server_lr scales asynchronous commit deltas; it requires "
                "async_mode=True (the synchronous driver applies rounds "
                "verbatim)")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.ef_capacity is not None and self.ef_capacity < 1:
            raise ValueError(
                f"ef_capacity must be >= 1, got {self.ef_capacity}")
        if not 0.0 < self.async_quantile <= 1.0:
            raise ValueError(
                f"async_quantile must be in (0, 1], got {self.async_quantile}")
        # a bad staleness spec fails here, not mid-trajectory
        from repro_torch.comm.async_driver import make_staleness

        make_staleness(self.staleness)
        # a private copy: the downlink merge must never mutate a caller's dict
        self.codecs = (dict(self.codecs) if isinstance(self.codecs, dict)
                       else {"default": self.codecs})
        if self.downlink_codecs is not None:
            shorthand = (self.downlink_codecs
                         if isinstance(self.downlink_codecs, dict)
                         else {"default": self.downlink_codecs})
            for name, spec in shorthand.items():
                self.codecs.setdefault(f"{DOWN}{name}", spec)
        if self.ef_variant not in feedback.EF_VARIANTS:
            raise ValueError(
                f"unknown ef_variant {self.ef_variant!r}; "
                f"want one of {feedback.EF_VARIANTS}")
        self._codec_cache: Dict[str, Codec] = {}
        self._channel_view = None  # (t, the channel process's view)
        self.scheduler = make_scheduler(self.scheduler)

    def codec_for(self, payload: str) -> Codec:
        """Resolve a payload (``"name"`` uplink / ``"down:name"``
        downlink) to its codec. Each direction has its own default."""
        if payload not in self._codec_cache:
            if payload in self.codecs:
                spec = self.codecs[payload]
            elif payload in _LOSSLESS_BY_DEFAULT:
                spec = "identity"
            elif payload.startswith(DOWN):
                spec = self.codecs.get(f"{DOWN}default", "identity")
            else:
                spec = self.codecs.get("default", "identity")
            self._codec_cache[payload] = make_codec(spec)
        return self._codec_cache[payload]

    def ef_for(self, payload: str) -> bool:
        """EF is folded in only where it can matter: requested AND lossy."""
        return (feedback.ef_requested(self.error_feedback, payload)
                and not self.codec_for(payload).lossless)

    @property
    def has_error_feedback(self) -> bool:
        return feedback.any_ef_requested(self.error_feedback)

    def channel_at(self, t: int):
        """The channel as seen at round ``t``: the static model itself
        without a ``ChannelProcess`` (the same object), else a per-round
        modulated view with the same methods (the latest round's kept)."""
        dyn = self.dynamics
        if dyn is None or dyn.channel is None:
            return self.channel
        if self._channel_view is None or self._channel_view[0] != t:
            self._channel_view = (t, dyn.channel.at(self.channel, t))
        return self._channel_view[1]


def apply_churn(session, t: int) -> "np.ndarray | None":
    """Churn bookkeeping of every session at round (or version) ``t``:
    returns the eligible ids (None without churn), retires the newly
    departed clients' EF rows through the session's ``_retire_ef``,
    counts them (``clients_departed``) and sets the
    ``active_population`` gauge.

    Idempotent within one ``t`` (the async driver may dispatch a version
    more than once). If churn empties the population, the full id set
    is restored with a one-time warning: a trajectory cannot run over
    zero clients.
    """
    dyn = session.config.dynamics
    if dyn is None or dyn.churn is None:
        return None
    elig = dyn.churn.eligible_mask(t, session.m)
    if not elig.any():
        if not session._churn_warned:
            session._churn_warned = True
            obs_log.warn_with_context(
                "churn left zero eligible clients; treating the full "
                "population as eligible so the trajectory can proceed",
                round=t, m=session.m)
        elig = np.ones(session.m, dtype=bool)
    prev = session._elig_prev
    session._elig_prev = elig
    if prev is not None:
        departed = np.nonzero(prev & ~elig)[0]
        if departed.size:
            session._retire_ef(departed)
            session.obs.metrics.counter("clients_departed").inc(
                float(departed.size))
    if session.obs.enabled:
        session.obs.metrics.gauge("active_population").set(float(elig.sum()))
    return np.nonzero(elig)[0].astype(np.int64)


class CommRound:
    """One round's transport view. ``mask`` is the (m,) delivery mask on
    the device (None on the statically full path), ``codec_key`` the
    round's host key for codec noise, ``memory`` the EF memory dict
    carried in from the previous round, ``plan`` the variant's byte plan
    (filled here), ``round_idx`` the round's index. With a threat model
    the sessions pass ``(mask, attackers)``, the second the (m,) 0/1
    attacker indicator on the device."""

    def __init__(self, config: CommConfig, plan: Dict[str, int],
                 mask, codec_key: "torch.Tensor | None",
                 memory: "Dict[str, torch.Tensor] | None" = None,
                 round_idx: int = 0):
        self._config = config
        self._plan = plan
        self.attackers = None
        if isinstance(mask, tuple):
            mask, self.attackers = mask
        self.mask = mask
        self._key = codec_key
        self.round_idx = round_idx
        self._n_payloads = 0
        self._n_down = 0
        self._occurrences: Dict[str, int] = {}
        # starts as a copy so payloads a round skips keep their memory
        self.memory_out: Dict[str, torch.Tensor] = dict(memory or {})
        # robust-aggregation counters (device scalars); empty without
        # dynamics
        self.stats_out: Dict[str, torch.Tensor] = {}

    def _payload_key(self, name: str) -> str:
        """Stable key for the i-th occurrence of ``name`` in the round: a
        round sending ``name`` twice bills (and remembers) both."""
        occ = self._occurrences.get(name, 0)
        self._occurrences[name] = occ + 1
        return name if occ == 0 else f"{name}#{occ}"

    def codec_noise(self, stream: int, shape: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        """The U[0,1) noise of one lossy payload occurrence: ``stream`` is
        the uplink counter (from 1) or ``_DOWNLINK_KEY_STREAM`` plus the
        downlink counter, ``shape`` is ``(rows,) + noise_shape``."""
        key = key_from_ints(key_bits(self._key), stream)
        return torch.rand(shape, generator=generator(key, device),
                          dtype=dtype, device=device)

    def threat_noise(self, stream: int, shape: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
        """The N(0, 1) draw a ``noise`` threat replaces an attacker's
        payload with: ``stream`` is ``_THREAT_KEY_STREAM`` plus the uplink
        counter, ``shape`` the stacked payload's."""
        key = key_from_ints(key_bits(self._key), stream)
        return torch.randn(shape, generator=generator(key, device),
                           dtype=dtype, device=device)

    def _noise(self, codec: Codec, stream: int, x: torch.Tensor):
        if codec.deterministic:
            return None
        shape = (x.shape[0],) + tuple(codec.noise_shape(tuple(x.shape[1:])))
        return self.codec_noise(stream, shape, x.dtype, x.device)

    def uplink(self, name: str, x: torch.Tensor,
               wire_shape: "tuple | None" = None, ef_eligible: bool = True,
               ef_reset=None) -> torch.Tensor:
        """Route a stacked per-client payload ``x: (m, ...)`` through its
        codec; records its exact encoded bytes per client.

        ``wire_shape`` is the shape billed where the algorithm defines its
        own wire format (FedNL sends a rank-1 ``(M + 1,)`` eigenpair, not
        the (M, M) difference); the codec prices that shape.
        ``ef_eligible=False`` marks a payload whose basis is redrawn every
        round, so error feedback skips it. ``ef_reset`` (a bool) zeroes
        its EF memory first: the round a rotating basis is redrawn.

        With dynamics, a threat corrupts the attackers' rows before the
        codec (EF memory tracks that wire payload), and a robust
        aggregator transforms what the codec decoded, the identity
        codec's too."""
        codec = self._config.codec_for(name)
        pkey = self._payload_key(name)
        self._plan[pkey] = codec.nbytes(
            tuple(wire_shape) if wire_shape is not None
            else tuple(x.shape[1:]), x.dtype)
        self._n_payloads += 1
        dyn = self._config.dynamics
        if dyn is None:
            return self._roundtrip(codec, name, pkey, x, ef_eligible,
                                   ef_reset)
        threat = dyn.threat
        if (threat is not None and self.attackers is not None
                and threat.applies(name)):
            noise = (self.threat_noise(
                _THREAT_KEY_STREAM + self._n_payloads, tuple(x.shape),
                x.dtype, x.device) if threat.kind == "noise" else None)
            x = threat.corrupt(x, self.attackers, noise)
        decoded = self._roundtrip(codec, name, pkey, x, ef_eligible, ef_reset)
        if dyn.robust is not None:
            # the server's defence on what it received; the clients'
            # EF memory above tracks the wire payload
            decoded = dyn.robust(decoded, self.mask, self.stats_out)
        return decoded

    def _roundtrip(self, codec: Codec, name: str, pkey: str, x: torch.Tensor,
                   ef_eligible: bool, ef_reset) -> torch.Tensor:
        """One payload through its codec, with its EF memory."""
        if isinstance(codec, IdentityCodec):
            return x  # the same object: no change to the round
        u = self._noise(codec, self._n_payloads, x)
        if not (ef_eligible and self._config.ef_for(name)):
            return codec.roundtrip(x, u)
        mem = self.memory_out.get(pkey)
        if mem is None:  # the payload's first uplink: zero memory
            mem = feedback.init_memory({pkey: x})[pkey]
        if ef_reset is not None:
            # basis rotated: compensate from a zeroed memory this round
            mem = mem * (1.0 - float(ef_reset))
        decoded, mem_new = feedback.compensate(
            codec, u, x, mem, variant=self._config.ef_variant)
        # dropped clients never ran the round: their rows keep the
        # (post-reset) memory
        self.memory_out[pkey] = self.where_delivered(mem_new, mem)
        return decoded

    def downlink(self, name: str, x: torch.Tensor,
                 wire_shape: "tuple | None" = None) -> torch.Tensor:
        """Route a server broadcast (no client axis) through its
        ``"down:<name>"`` codec: encoded once, billed ``nbytes`` (of
        ``wire_shape`` where given) per receiving client. No error
        feedback applies."""
        codec = self._config.codec_for(f"{DOWN}{name}")
        pkey = self._payload_key(f"{DOWN}{name}")
        self._plan[pkey] = codec.nbytes(
            tuple(wire_shape) if wire_shape is not None else tuple(x.shape),
            x.dtype)
        self._n_down += 1
        if isinstance(codec, IdentityCodec):
            return x
        one = x.unsqueeze(0)
        u = self._noise(codec, _DOWNLINK_KEY_STREAM + self._n_down, one)
        return codec.roundtrip(one, u)[0]

    def weights(self, p: torch.Tensor) -> torch.Tensor:
        """Aggregation weights restricted to the delivering cohort."""
        if self.mask is None:
            return p
        pm = p * self.mask
        return pm / torch.sum(pm)

    def where_delivered(self, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        """Per-client update gate: non-delivering clients keep ``old``.
        The leading axis is the client axis."""
        if self.mask is None:
            return new
        shape = (-1,) + (1,) * (new.ndim - 1)
        return torch.where(self.mask.reshape(shape) > 0, new, old)


class _NullComm:
    """No-transport stand-in: uplinks, downlinks and weights are the
    identity, so the comm-aware code path is the only code path."""

    mask = None

    def uplink(self, name, x, wire_shape=None, ef_eligible=True,
               ef_reset=None):
        return x

    def downlink(self, name, x, wire_shape=None):
        return x

    def weights(self, p):
        return p

    def where_delivered(self, new, old):
        return new

    @property
    def memory_out(self):
        return {}

    @property
    def stats_out(self):
        return {}


NULL_COMM = _NullComm()


class SessionDynamics:
    """The session side of scenario dynamics, shared by the four
    transport drivers: the churn state ``apply_churn`` keeps, the
    attacker indicator the rounds take, the robust counters
    (``robust_stats``, mirrored into telemetry) and the EF retirement
    of departed clients. Inert without dynamics. The sessions set
    ``config``, ``m``, ``obs``, ``ef_memory``, ``_device`` and
    ``_mask_dtype``."""

    def _init_dynamics(self) -> None:
        self._elig_prev = None  # (m,) eligibility at the last apply_churn
        self._churn_warned = False
        self._attackers_host = None  # (m,) bool, for the dense axis
        self._attackers = None  # the same, 0/1 on the device
        self.robust_stats: Dict[str, float] = {}

    def _attacker_rows(self, ids) -> np.ndarray:
        """The attackers among ``ids`` (None: all m clients, cached)."""
        threat = self.config.dynamics.threat
        if ids is not None:
            return threat.attacker_mask(ids)
        if self._attackers_host is None:
            self._attackers_host = threat.attacker_mask(np.arange(self.m))
        return self._attackers_host

    def _pack_threat(self, mask, ids=None):
        """The delivery mask as the round takes it: bundled with the
        attacker indicator of the round's rows when a threat is active
        (``ids`` the cohort's ids; None on the dense axis, whose (m,)
        indicator is cached on the device)."""
        dyn = self.config.dynamics
        if dyn is None or dyn.threat is None:
            return mask
        if ids is None:
            if self._attackers is None:
                self._attackers = host_to(self._attacker_rows(None),
                                          self._device, self._mask_dtype)
            return (mask, self._attackers)
        return (mask, host_to(self._attacker_rows(ids), self._device,
                              self._mask_dtype))

    def _consume_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Add a round's robust counters to ``robust_stats`` and the
        telemetry: one read from the device, none without counters."""
        if not stats:
            return
        values = torch.stack([v.to(torch.float64)
                              for v in stats.values()]).tolist()
        for name, v in zip(stats, values):
            self.robust_stats[name] = self.robust_stats.get(name, 0.0) + v
            self.obs.metrics.counter(name).inc(v)

    def _count_corrupted(self, delivered: np.ndarray,
                         ids: "np.ndarray | None") -> None:
        """Count the corrupted uploads the server took this round
        (attacker AND delivered): ``uploads_corrupted``."""
        dyn = self.config.dynamics
        if dyn is None or dyn.threat is None:
            return
        n_bad = float((self._attacker_rows(ids) & delivered).sum())
        self.robust_stats["uploads_corrupted"] = \
            self.robust_stats.get("uploads_corrupted", 0.0) + n_bad
        self.obs.metrics.counter("uploads_corrupted").inc(n_bad)

    def _retire_ef(self, departed: np.ndarray) -> None:
        """Zero the departed clients' rows of the dense EF memory."""
        self.ef_memory = {
            name: v.index_fill(0, host_to(departed, v.device, torch.int64), 0)
            for name, v in self.ef_memory.items()}


class CommSession(SessionDynamics):
    """Host-side per-trajectory transport state for the synchronous
    lock-step clock: ``step`` draws a cohort and channel coins, runs the
    round, and accounts it; ``finalize`` folds the traces into the
    ``Transport`` axes ``History`` carries. ``obs`` is the run's
    telemetry (``repro_torch.obs.Telemetry``) or the shared no-op."""

    def __init__(self, config: CommConfig, m: int, *, keys: torch.Tensor,
                 state0: Any, mask_dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda",
                 obs=NULL_TELEMETRY):
        self.config = config
        self.m = int(m)
        self.obs = obs
        self.keys = keys
        self._state = state0
        self._mask_dtype = mask_dtype
        self._device = resolve_device(device)
        self._t = 0
        # the byte plan of each round variant, filled by its first round
        self._plans: "Dict[Any, Dict[str, int]]" = {}
        self._variant: Any = _NO_VARIANT
        self.traces: "list[RoundTrace]" = []
        self.ef_memory: Dict[str, torch.Tensor] = {}
        self._pending = None
        # static decision: no round of this trajectory needs a mask.
        # Churn and outages force one every round
        dyn = config.dynamics
        self._always_full = (config.scheduler.is_full
                             and config.channel.dropout_prob == 0.0
                             and (dyn is None or not dyn.forces_mask))
        self._init_dynamics()

    @property
    def plan(self) -> Dict[str, int]:
        """The byte plan of the current variant (empty before its first
        round)."""
        return self._plans.setdefault(self._variant, {})

    @property
    def bytes_up_per_client(self) -> int:
        """Encoded uplink bytes per delivering client per round."""
        return plan_bytes(self.plan, down=False)

    @property
    def bytes_down_per_client(self) -> int:
        """Encoded broadcast bytes per scheduled client per round."""
        return plan_bytes(self.plan, down=True)

    # -- Session protocol ----------------------------------------------------
    def prepare(self, round_fn) -> None:
        """Before the first round: nothing to discover (the byte plan
        fills during each variant's first round)."""

    def begin_variant(self, sig) -> None:
        """Announce the round variant about to run: later rounds bill its
        byte plan (adaptive-k policies change payload sizes)."""
        self._variant = sig

    def comm_round(self, memory, mask, codec_key) -> CommRound:
        """The transport view the round builder hands to the optimizer."""
        return CommRound(self.config, self.plan, mask, codec_key,
                         memory=memory, round_idx=self._t)

    def step(self, round_fn) -> Any:
        """One lock-step round: draw the cohort, execute, account."""
        t = self._t
        mask, ck = self.begin_round(t)
        self._state, self.ef_memory, stats = round_fn(
            self._state, self.ef_memory, self.keys[t], mask, ck)
        self._consume_stats(stats)
        self.end_round()
        self._t += 1
        return self._state

    def finalize(self) -> Transport:
        self._observe_ef()
        return transport_from_traces(
            self.traces, ef_residuals=self.ef_residual_norms())

    def _observe_ef(self) -> None:
        observe_ef_memory(self.obs, self.ef_memory)

    def ef_residual_norms(self) -> "Dict[str, float]":
        """Per-payload Frobenius norm of the current EF memory."""
        return feedback.residual_norms(self.ef_memory)

    def begin_round(self, t: int):
        """Draw round ``t``'s cohort and channel coins. Returns ``(mask,
        codec_key)``: ``mask`` is None on the statically full path, else
        the (m,) delivery mask on the device (packed with the attackers
        under a threat)."""
        k_sched, k_chan, k_codec = round_keys(self.config.seed, t)
        eligible = apply_churn(self, t)
        chan = self.config.channel_at(t)
        scheduled = self.config.scheduler.participants(
            k_sched, t, self.m, chan, eligible=eligible)
        draw = chan.draw(k_chan, self.m)
        delivered = scheduled & ~draw.dropout
        if scheduled.any() and not delivered.any():
            # every scheduled client dropped: the server re-polls the
            # lowest-index scheduled one so the weights stay defined
            delivered = np.zeros_like(scheduled)
            delivered[int(np.argmax(scheduled))] = True
        self._pending = (t, scheduled, delivered, draw)
        if self._always_full:
            return self._pack_threat(None), k_codec
        return self._pack_threat(
            host_to(delivered, self._device, self._mask_dtype)), k_codec

    def end_round(self) -> RoundTrace:
        """Account the round just executed from the variant's byte plan,
        both directions."""
        t, scheduled, delivered, draw = self._pending
        bytes_up = float(self.bytes_up_per_client) * delivered.astype(np.float64)
        bytes_down = (float(self.bytes_down_per_client)
                      * scheduled.astype(np.float64))
        sim = self.config.channel_at(t).round_time(draw, delivered, bytes_up,
                                                   bytes_down)
        trace = RoundTrace(
            round=t,
            scheduled=scheduled,
            delivered=delivered,
            straggler=draw.straggler & delivered,
            bytes_up=bytes_up,
            bytes_down=bytes_down,
            sim_time_s=sim,
        )
        self.traces.append(trace)
        self._pending = None
        self._count_corrupted(delivered, None)
        if self.obs.enabled:
            self._observe(trace)
        return trace

    def _observe(self, trace: RoundTrace) -> None:
        """Per-round telemetry, on the host after the round ran."""
        mt = self.obs.metrics
        up = float(trace.bytes_up.sum())
        down = float(trace.bytes_down.sum())
        dropped = trace.scheduled & ~trace.delivered
        mt.counter("bytes_up").inc(up)
        mt.counter("bytes_down").inc(down)
        mt.counter("scheduled_client_rounds").inc(
            float(trace.scheduled.sum()))
        mt.counter("delivered_client_rounds").inc(
            float(trace.delivered.sum()))
        mt.counter("dropped_client_rounds").inc(float(dropped.sum()))
        mt.counter("straggler_client_rounds").inc(
            float(trace.straggler.sum()))
        self.obs.annotate(
            bytes_up=up, bytes_down=down,
            delivered=int(trace.delivered.sum()),
            dropped=int(dropped.sum()),
            sim_time_s=float(trace.sim_time_s))


class PopulationCommSession(CommSession):
    """Synchronous driver over a ``ClientPopulation``.

    Per round: sample the cohort's ids (``Scheduler.sample_ids``, the
    dense mask's draw), materialize exactly those shards, draw the
    cohort's coins per id (``ChannelModel.draw_for``), gather the
    cohort's EF rows from the bounded hot set, run the round and scatter
    the rows back. Nothing (m,)-shaped reaches the device; the host holds
    O(m) metadata (shard sizes, the scheduler's draw).

    The round function takes the cohort problem first: ``round_fn(cohort,
    state, memory, key, mask, codec_key) -> (state, memory, stats)``.
    Every member is scheduled by construction, so the mask carries
    dropout only: without dropout (and without churn or outages) the
    round runs with ``mask=None``. When churn leaves fewer eligible ids
    than the cohort size, the cohort is padded with its first id under
    a zero mask, so every round has the one cohort width.
    """

    def __init__(self, config: CommConfig, population, *, keys: torch.Tensor,
                 state0: Any, mask_dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda",
                 obs=NULL_TELEMETRY):
        super().__init__(config, population.m, keys=keys, state0=state0,
                         mask_dtype=mask_dtype, device=device, obs=obs)
        self.population = population
        self.cohort_size = config.scheduler.cohort_size(population.m)
        self.ef_store = (feedback.BoundedMemory(ef_capacity(
            config, population.m, self.cohort_size))
            if config.has_error_feedback else None)
        dyn = config.dynamics
        self._always_full = (config.channel.dropout_prob == 0.0
                             and (dyn is None or not dyn.forces_mask))
        self._pending_ids = None
        self._pending_real = None

    def begin_round(self, t: int):
        """Sample round ``t``'s cohort ids and their coins, on the dense
        driver's key schedule (``round_keys``). Returns ``(ids, mask,
        codec_key)``."""
        k_sched, k_chan, k_codec = round_keys(self.config.seed, t)
        eligible = apply_churn(self, t)
        chan = self.config.channel_at(t)
        ids = self.config.scheduler.sample_ids(k_sched, t, self.m, chan,
                                               eligible=eligible)
        n_real = len(ids)
        if n_real < self.cohort_size:
            # churn shrank the eligible set below the cohort size: pad
            # with the first sampled id under a zero delivery mask
            ids = np.concatenate([
                ids, np.full(self.cohort_size - n_real, ids[0],
                             dtype=np.int64)])
        draw = chan.draw_for(k_chan, ids)
        delivered = ~draw.dropout
        delivered[n_real:] = False
        if not delivered.any():
            # every sampled client dropped: re-poll the lowest id so the
            # weights stay defined (the dense rule)
            delivered = np.zeros_like(delivered)
            delivered[0] = True
        scheduled = np.ones_like(delivered)
        scheduled[n_real:] = False
        self._pending = (t, scheduled, delivered, draw)
        self._pending_ids = ids
        self._pending_real = n_real
        if self._always_full:
            return ids, self._pack_threat(None, ids), k_codec
        mask = host_to(delivered, self._device, self._mask_dtype)
        return ids, self._pack_threat(mask, ids), k_codec

    def step(self, round_fn) -> Any:
        """One cohort round: sample ids, materialize, execute, account."""
        t = self._t
        ids, mask, ck = self.begin_round(t)
        cohort = self.population.materialize(ids)
        memory = self.ef_store.gather(ids) if self.ef_store else {}
        self._state, mem_out, stats = round_fn(cohort, self._state, memory,
                                               self.keys[t], mask, ck)
        self._consume_stats(stats)
        if self.ef_store is not None:
            # real ids only: churn's pad rows repeat ids[0]
            self.ef_store.scatter(ids[:self._pending_real], mem_out)
        self.end_round()
        self._t += 1
        return self._state

    def _retire_ef(self, departed: np.ndarray) -> None:
        """Departed clients leave the EF hot set: their slots are freed
        and zeroed (``BoundedMemory.retire``)."""
        if self.ef_store is not None:
            self.ef_store.retire(departed)

    def end_round(self) -> RoundTrace:
        t, scheduled, delivered, draw = self._pending
        ids = self._pending_ids
        bytes_up = float(self.bytes_up_per_client) * delivered.astype(np.float64)
        bytes_down = (float(self.bytes_down_per_client)
                      * scheduled.astype(np.float64))
        sim = self.config.channel_at(t).round_time_for(
            ids, self.m, draw, delivered, bytes_up, bytes_down)
        trace = RoundTrace(
            round=t,
            scheduled=scheduled,
            delivered=delivered,
            straggler=draw.straggler & delivered,
            bytes_up=bytes_up,
            bytes_down=bytes_down,
            sim_time_s=sim,
            ids=ids,
            population=self.m,
        )
        self.traces.append(trace)
        self._pending = None
        self._pending_ids = None
        self._pending_real = None
        self._count_corrupted(delivered, ids)
        if self.obs.enabled:
            self._observe(trace)
        return trace

    def _observe_ef(self) -> None:
        observe_ef_store(self.obs, self.ef_store)

    def ef_residual_norms(self) -> "Dict[str, float]":
        return self.ef_store.residual_norms() if self.ef_store else {}


def observe_ef_memory(obs, memory: Dict[str, torch.Tensor]) -> None:
    """The dense EF memory's final footprint, all clients, as a gauge
    (telemetry on only)."""
    if obs.enabled:
        obs.metrics.gauge("ef_memory_bytes").set(
            float(sum(x.numel() * x.element_size() for x in memory.values())))


def observe_ef_store(obs, store: "feedback.BoundedMemory | None") -> None:
    """The EF hot set's final footprint and evictions as gauges (telemetry
    on only)."""
    if obs.enabled:
        obs.metrics.gauge("ef_memory_bytes").set(
            float(store.nbytes if store is not None else 0))
        if store is not None:
            obs.metrics.gauge("ef_hot_set_evictions").set(
                float(store.evictions))


def ef_capacity(config: CommConfig, m: int, cohort_size: int) -> int:
    """The EF hot set's size: ``CommConfig.ef_capacity``, by default
    ``min(m, 8 x cohort size)``, never below one cohort."""
    capacity = config.ef_capacity
    if capacity is None:
        capacity = min(m, 8 * cohort_size)
    return max(capacity, cohort_size)
