"""Event-driven asynchronous federated round driver.

Counterpart of ``repro.comm.async_driver``. The synchronous driver waits
for the slowest delivering client every round; this one keeps an event
clock on the per-client cycle times the channel produces
(``ChannelModel.client_times``):

  * every client runs its own download -> compute -> upload cycle on the
    model *version it last received*;
  * an upload lands when its simulated link finishes; a dropped upload
    re-dispatches (the client re-fetches the current model and retries
    with fresh coins, delivery forced after ``MAX_RETRIES`` drops);
  * the server commits once a quorum has buffered: ``buffer_size``
    arrivals (FedBuff's K) when set, else ``ceil(async_quantile * m)``;
  * a contribution computed on version ``v`` and committed at server
    version ``t`` has staleness ``tau = t - v`` and is weighted by
    ``make_staleness(CommConfig.staleness)``.

A commit groups its arrivals by base version, freshest first, and runs
the optimizer's round once per group from that version's snapshot with
the group's delivery mask. The server combines the groups' deltas:

    w_{t+1} = w_t + eta_s * sum_g c_g (w'_g - w_{v_g}),
    c_g  =  staleness(tau_g) * P_g / sum_h P_h

(P_g the group's participation mass, eta_s ``CommConfig.server_lr``).
Auxiliary state (momentum, guards) rides the freshest group's round when
it is current. A commit of one fresh group at ``server_lr`` 1 takes the
round's output as the next state with no delta arithmetic: with the full
scheduler, no dropout and a full quorum every commit is that branch with
``mask=None``, which makes the async trajectory bit-identical to the
synchronous one (same keys, same rounds, same floats).

Snapshots of the model versions still referenced by an upload in flight
or in the buffer stay on the device; the rest are dropped after each
commit. EF memory threads through every group round, gated by that
group's mask. Keys follow the synchronous schedule (``round_keys(seed,
version)``); a retry folds its count into the coin key.

``PopulationAsyncSession`` runs the same clock over a
``ClientPopulation``: cohorts of ids per version, dropped clients
replaced rather than retried, groups materialized on demand and EF rows
in a bounded hot set.

Scenario dynamics (``CommConfig(dynamics=...)``) reach the clock at
dispatch: each version's cohort is drawn from the clients churn leaves
alive (``apply_churn``) on that version's channel (``channel_at``), an
upload whose client has departed by the time it lands is retired
(flight event ``retire``, counter ``uploads_retired``), never buffered,
and the group rounds take the attacker indicator beside their masks.
Churn and outages force the masked path (no lock-step commits).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import defaultdict
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.comm import feedback
from repro_torch.comm.config import (
    CohortSplit,
    CommRound,
    SessionDynamics,
    apply_churn,
    ef_capacity,
    observe_ef_memory,
    observe_ef_store,
    plan_bytes,
    round_keys,
)
from repro_torch.comm.metrics import RoundTrace, Transport, transport_from_traces
from repro_torch.device import host_to, resolve_device
from repro_torch.keys import fold_in
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.obs import log as obs_log

# a dropped upload is retried with fresh coins; after this many
# consecutive drops the delivery is forced so the clock cannot spin
MAX_RETRIES = 8

# begin_variant sentinel: "no variant announced yet" (None is a valid
# round signature)
_NO_VARIANT = object()


def make_staleness(spec: "str | Callable[[float], float]"):
    """Resolve a staleness spec to a ``tau -> weight`` callable:
    ``"constant"`` (1), ``"inverse"`` (1/(1+tau)), ``"poly:a"``
    ((1+tau)^-a, ``a`` 0.5 by default); a callable passes through."""
    if callable(spec):
        return spec
    if spec == "constant":
        return lambda tau: 1.0
    if spec == "inverse":
        return lambda tau: 1.0 / (1.0 + tau)
    kind, _, arg = str(spec).partition(":")
    if kind in ("poly", "polynomial"):
        a = float(arg or 0.5)
        return lambda tau: (1.0 + tau) ** (-a)
    raise ValueError(
        f"unknown staleness spec {spec!r}; want 'constant', 'inverse', "
        f"'poly:<a>', or a callable")


@dataclasses.dataclass
class _Flight:
    """One client upload cycle in the air."""

    client: int
    version: int  # model version the client computed on
    straggler: bool
    dropped: bool  # lost in transit: re-dispatch on landing
    retry: int = 0


class AsyncSession(SessionDynamics):
    """Host-side event-driven driver of one trajectory over a dense
    client axis: per-client clocks, the arrival heap, the server buffer,
    per-version state snapshots (on the device), the EF memory and the
    per-commit ``RoundTrace``s. ``step(round_fn)`` runs the events up to
    the next commit; ``round_fn(state, memory, key, mask, codec_key) ->
    (state, memory, stats)`` is the round every session drives. ``obs``
    is the run's telemetry: flight events of every dispatch, drop,
    arrival, retirement and commit, the commit histograms and the
    per-commit counters."""

    def __init__(self, config, m: int, client_weights: np.ndarray, *,
                 keys: torch.Tensor, state0: Any = None,
                 mask_dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda",
                 obs=NULL_TELEMETRY):
        self.config = config
        self.m = int(m)
        self.obs = obs
        self.client_weights = np.asarray(client_weights, dtype=np.float64)
        self.keys = keys
        self._state0 = state0
        self._mask_dtype = mask_dtype
        self._device = resolve_device(device)
        self.plan: Dict[str, int] = {}
        self.traces: List[RoundTrace] = []
        self.ef_memory: Dict[str, torch.Tensor] = {}
        self._staleness = make_staleness(config.staleness)
        if config.buffer_size is not None:
            self.quorum = min(self.m, int(config.buffer_size))
        else:
            self.quorum = max(1, min(self.m, int(math.ceil(
                config.async_quantile * self.m))))
        # lock-step equivalent: full scheduler, no dropout, full quorum.
        # Every commit then takes the fresh full cohort, so its round runs
        # with mask=None, as the synchronous driver's does. Churn and
        # outages break the full cohort, so they force the masked path
        dyn = config.dynamics
        self.lockstep = (config.scheduler.is_full
                         and config.channel.dropout_prob == 0.0
                         and self.quorum == self.m
                         and (dyn is None or not dyn.forces_mask))
        self._init_dynamics()
        self.version = 0
        self.server_clock = 0.0
        self._snapshots: Dict[int, Any] = {}
        self._heap: list = []  # (time, seq, _Flight)
        self._seq = 0
        self._buffer: List[tuple] = []  # (client, version, straggler, t_arr)
        self._idle: set = set()
        self._quorum_capped = False
        self._pending_down = np.zeros(self.m, dtype=np.float64)
        self._pending_dropped = np.zeros(self.m, dtype=bool)
        self._variant_sig: Any = _NO_VARIANT
        self._group_version = 0  # the version a running round computes on

    @property
    def bytes_up_per_client(self) -> int:
        return plan_bytes(self.plan, down=False)

    @property
    def bytes_down_per_client(self) -> int:
        """Encoded broadcast bytes per dispatched client."""
        return plan_bytes(self.plan, down=True)

    # -- Session protocol ----------------------------------------------------
    def prepare(self, round_fn) -> None:
        """Fill the byte plan before the first dispatch (the clock prices
        both directions at dispatch time), then snapshot the initial
        state and put the first cycles in the air. PyTorch has no
        shape-only trace, so the plan comes from one probe round run on
        the initial state and thrown away (rounds are pure functions of
        their inputs, so the trajectory does not change)."""
        mask = (None if self.lockstep else
                torch.ones(self.m, dtype=self._mask_dtype, device=self._device))
        self._probe(round_fn, self._pack_threat(mask))
        if self._state0 is not None:
            self.start(self._state0)

    def _probe(self, round_fn, mask) -> None:
        """Run the round once on the initial state and throw away all it
        returns: the state, the EF memory and the robust counters (the
        uploads it corrupts are counted nowhere)."""
        _, _, k_codec = round_keys(self.config.seed, 0)
        key = self.keys[0] if len(self.keys) else k_codec
        round_fn(self._state0, {}, key, mask, k_codec)

    def begin_variant(self, sig) -> None:
        """In-flight uploads were priced at dispatch, so the payload plan
        must hold for the whole trajectory: the first variant is taken,
        any later change (adaptive-k) raises."""
        if self._variant_sig is _NO_VARIANT:
            self._variant_sig = sig
        elif sig != self._variant_sig:
            raise NotImplementedError(
                "round-varying payload plans (adaptive-k sketch policies) "
                "are not supported by the asynchronous driver: uploads "
                "already in flight were priced at dispatch time; use the "
                "synchronous driver")

    def comm_round(self, memory, mask, codec_key, block=None) -> CommRound:
        return CommRound(self.config, self.plan, mask, codec_key,
                         memory=memory, round_idx=self._group_version,
                         block=block)

    def finalize(self) -> Transport:
        self._observe_ef()
        return transport_from_traces(
            self.traces,
            staleness=np.array([tr.mean_staleness for tr in self.traces]),
            ef_residuals=self.ef_residual_norms())

    def _observe_ef(self) -> None:
        observe_ef_memory(self.obs, self.ef_memory)

    def ef_residual_norms(self) -> Dict[str, float]:
        return feedback.residual_norms(self.ef_memory)

    # -- event machinery -----------------------------------------------------
    def start(self, state) -> None:
        """Snapshot the initial model and put every client in the air."""
        self._snapshots[0] = state
        self._dispatch_cohort(range(self.m), now=0.0)

    def _alive(self, j: int) -> bool:
        """Is client ``j`` churn-eligible as of the last dispatch?"""
        return self._elig_prev is None or bool(self._elig_prev[j])

    def _retire_flight(self, flight: _Flight, now: float) -> None:
        """A departed client's upload landed: it is retired, never
        buffered, and the client idles until it returns."""
        self._pending_dropped[flight.client] = True
        self._idle.add(flight.client)

    def _dispatch_cohort(self, clients, now: float) -> None:
        """Send the current model to the ``clients`` the scheduler picks
        this version; the rest idle until the next commit."""
        clients = list(clients)
        if not clients:
            return
        k_sched, k_chan, _ = round_keys(self.config.seed, self.version)
        eligible = apply_churn(self, self.version)
        chan = self.config.channel_at(self.version)
        scheduled = self.config.scheduler.participants(
            k_sched, self.version, self.m, chan, eligible=eligible)
        cohort = [j for j in clients if scheduled[j]]
        if not cohort and not self._heap and not self._buffer:
            # nothing else in flight: dispatch the alive clients (all of
            # them if none is) to avoid a stall
            cohort = [j for j in clients if self._alive(j)] or clients
        chosen = set(cohort)
        self._idle.update(j for j in clients if j not in chosen)
        draw = chan.draw(k_chan, self.m)
        times = self._flight_times(draw)
        for j in cohort:
            self._idle.discard(j)
            self._launch(j, now, times[j], bool(draw.straggler[j]),
                         bool(draw.dropout[j]), retry=0)

    def _redispatch(self, j: int, now: float, retry: int) -> None:
        """A dropped upload landed: the client re-fetches the current
        model and retries with coins of a key folded with the retry."""
        if not self._alive(j):
            self._idle.add(j)
            return
        _, k_chan, _ = round_keys(self.config.seed, self.version)
        chan = self.config.channel_at(self.version)
        draw = chan.draw(fold_in(k_chan, retry), self.m)
        dropped = bool(draw.dropout[j]) and retry < MAX_RETRIES
        times = self._flight_times(draw)
        self._launch(j, now, times[j], bool(draw.straggler[j]), dropped,
                     retry=retry)

    def _flight_times(self, draw) -> np.ndarray:
        """(m,) cycle times of a dense dispatch, both directions at their
        encoded sizes."""
        bytes_up = np.full(self.m, float(self.bytes_up_per_client))
        bytes_down = np.full(self.m, float(self.bytes_down_per_client))
        return self.config.channel_at(self.version).client_times(
            draw, bytes_up, bytes_down)

    def _launch(self, j: int, now: float, dt: float, straggler: bool,
                dropped: bool, retry: int) -> None:
        self._pending_down[j] += self.bytes_down_per_client
        self._seq += 1
        flight = _Flight(client=j, version=self.version,
                         straggler=straggler, dropped=dropped, retry=retry)
        heapq.heappush(self._heap, (now + dt, self._seq, flight))
        self.obs.flight.record(
            "dispatch", now, client=j, version=self.version,
            eta=now + dt, straggler=straggler, retry=retry)
        if retry:
            self.obs.metrics.counter("upload_retries").inc()

    def _pump(self) -> float:
        """Advance the event clock until the quorum has buffered; returns
        the commit time (the quorum-th arrival's landing). The quorum is
        capped at what can still arrive (buffered + in flight), so a
        partial scheduler cannot deadlock the clock."""
        t = self.server_clock
        while True:
            need = max(1, min(self.quorum, len(self._buffer) + len(self._heap)))
            if need < self.quorum and not self._quorum_capped:
                self._quorum_capped = True
                obs_log.warn_with_context(
                    f"async commit quorum capped at {need} (< configured "
                    f"{self.quorum}): the scheduler keeps fewer clients in "
                    f"flight than the quorum asks for",
                    category=RuntimeWarning, stacklevel=3,
                    server_version=self.version, quorum=self.quorum,
                    capped_to=need)
            if len(self._buffer) >= need:
                return t
            if not self._heap:
                # everything idled out: force-dispatch to make progress
                self._dispatch_cohort(sorted(self._idle), now=t)
                continue
            t, _, flight = heapq.heappop(self._heap)
            if not self._alive(flight.client):
                # the client churned out while its upload was in the air
                self._retire_flight(flight, t)
                self.obs.flight.record("retire", t, client=flight.client,
                                       version=flight.version)
                self.obs.metrics.counter("uploads_retired").inc()
                continue
            if flight.dropped:
                self._pending_dropped[flight.client] = True
                self.obs.flight.record(
                    "drop", t, client=flight.client, version=flight.version,
                    retry=flight.retry)
                self._redispatch(flight.client, t, flight.retry + 1)
            else:
                self._buffer.append(
                    (flight.client, flight.version, flight.straggler, t))
                self.obs.flight.record(
                    "arrival", t, client=flight.client,
                    version=flight.version, server_version=self.version,
                    buffered=len(self._buffer))

    # -- one server commit ---------------------------------------------------
    def _groups(self, committed) -> "tuple[Dict[int, list], list]":
        """Arrivals grouped by the version they computed on, and the
        versions freshest first."""
        groups: Dict[int, List[int]] = {}
        for client, version, _, _ in committed:
            groups.setdefault(version, []).append(client)
        return groups, sorted(groups, reverse=True)

    def _combine(self, groups, order, outputs) -> Any:
        """The next server state from the groups' round outputs."""
        fresh = order[0]
        eta = float(self.config.server_lr)
        if len(order) == 1 and fresh == self.version and eta == 1.0:
            # the lock-step branch: one fresh group at unit server lr, its
            # round output IS the next state (no delta arithmetic; the
            # staleness weight is 1 at tau = 0 by convention)
            return outputs[fresh]
        # c_g = eta_s * staleness(tau_g) * P_g / sum_h P_h: participation
        # renormalized over the commit, staleness damping the step
        p_mass = {v: float(self.client_weights[groups[v]].sum())
                  for v in order}
        p_total = sum(p_mass.values())
        w_new = self._snapshots[self.version]["w"]
        for v in order:
            c = (eta * self._staleness(float(self.version - v))
                 * p_mass[v] / p_total)
            delta = outputs[v]["w"] - self._snapshots[v]["w"]
            w_new = w_new + c * delta
        # auxiliary state rides the freshest group's round when that
        # group is current; otherwise only the model moves
        base = (outputs[fresh] if fresh == self.version
                else self._snapshots[self.version])
        state_new = dict(base)
        state_new["w"] = w_new
        return state_new

    def _mask(self, width: int, members) -> "torch.Tensor | None":
        if self.lockstep:
            return None
        mvec = np.zeros(width)
        mvec[members] = 1.0
        return host_to(mvec, self._device, self._mask_dtype)

    def step(self, round_fn) -> Any:
        """Run the events up to the next commit and return the committed
        state."""
        commit_time = self._pump()
        committed, self._buffer = self._buffer, []
        if self.obs.enabled:
            self._observe_commit(committed, commit_time)
        groups, order = self._groups(committed)
        outputs: Dict[int, Any] = {}
        for v in order:
            _, _, k_codec = round_keys(self.config.seed, v)
            self._group_version = v
            outputs[v], self.ef_memory, stats = round_fn(
                self._snapshots[v], self.ef_memory, self.keys[v],
                self._pack_threat(self._mask(self.m, groups[v])), k_codec)
            self._consume_stats(stats)
        state_new = self._combine(groups, order, outputs)
        self._record_trace(committed, commit_time)
        self._advance(state_new, commit_time)
        self._dispatch_cohort(
            sorted({c for c, _, _, _ in committed} | self._idle),
            now=commit_time)
        return state_new

    def _observe_commit(self, committed, commit_time: float) -> None:
        """Commit-time telemetry, on the host before the group rounds."""
        mt = self.obs.metrics
        mt.histogram("commit_buffer_depth").observe(len(committed))
        mt.histogram("inflight_depth").observe(len(self._heap))
        mt.histogram("staleness").observe_many(
            float(self.version - v) for _, v, _, _ in committed)
        mt.histogram("buffered_upload_age_s").observe_many(
            commit_time - t_arr for _, _, _, t_arr in committed)
        self.obs.flight.record(
            "commit", commit_time, version=self.version + 1,
            server_version=self.version,
            clients=sorted(c for c, _, _, _ in committed),
            inflight=len(self._heap))

    def _observe_trace(self, tr: RoundTrace, dropped: int) -> None:
        """The commit's counters and round annotations (telemetry on)."""
        mt = self.obs.metrics
        up, down = float(tr.bytes_up.sum()), float(tr.bytes_down.sum())
        mt.counter("bytes_up").inc(up)
        mt.counter("bytes_down").inc(down)
        mt.counter("delivered_client_rounds").inc(float(tr.delivered.sum()))
        mt.counter("dropped_client_rounds").inc(float(dropped))
        mt.counter("straggler_client_rounds").inc(float(tr.straggler.sum()))
        self.obs.annotate(
            bytes_up=up, bytes_down=down,
            delivered=int(tr.delivered.sum()), version=tr.version,
            mean_staleness=tr.mean_staleness,
            sim_time_s=float(tr.sim_time_s))

    def _advance(self, state_new, commit_time: float) -> None:
        self.version += 1
        self.server_clock = commit_time
        self._snapshots[self.version] = state_new
        self._gc_snapshots()

    def _record_trace(self, committed, commit_time: float) -> None:
        mask = np.zeros(self.m, dtype=bool)
        straggler = np.zeros(self.m, dtype=bool)
        stale = np.full(self.m, np.nan)
        for client, version, was_straggler, _ in committed:
            mask[client] = True
            straggler[client] = was_straggler
            stale[client] = float(self.version - version)
        # scheduled minus delivered: clients whose upload was lost in this
        # window and who landed no retry before the commit
        self.traces.append(RoundTrace(
            round=self.version,
            scheduled=mask | self._pending_dropped,
            delivered=mask,
            straggler=straggler,
            bytes_up=float(self.bytes_up_per_client) * mask.astype(np.float64),
            bytes_down=self._pending_down,
            sim_time_s=commit_time - self.server_clock,
            staleness=stale,
            version=self.version + 1,
        ))
        self._count_corrupted(mask, None)
        if self.obs.enabled:
            self._observe_trace(self.traces[-1], self._pending_dropped.sum())
        self._pending_down = np.zeros(self.m, dtype=np.float64)
        self._pending_dropped = np.zeros(self.m, dtype=bool)

    def _gc_snapshots(self) -> None:
        """Drop the snapshots no upload in flight or buffered refers to."""
        alive = {self.version}
        alive.update(f.version for _, _, f in self._heap if not f.dropped)
        alive.update(v for _, v, _, _ in self._buffer)
        for v in [v for v in self._snapshots if v not in alive]:
            del self._snapshots[v]


class PopulationAsyncSession(CohortSplit, AsyncSession):
    """Event-driven driver over a ``ClientPopulation``.

    The clock of ``AsyncSession`` with cohorts of ids in place of the
    client axis:

      * each version samples its cohort (``Scheduler.sample_ids`` on the
        synchronous population driver's keys, so both drivers schedule
        the same cohorts) and dispatches the ids not already in flight,
        at most one cohort in the air; landed clients return to the pool;
      * a dropped upload is replaced, not retried: the client goes back
        to the pool. If every upload in the air dropped, the version's
        cohort redraws its coins with a folded attempt counter (delivery
        forced after ``MAX_RETRIES`` attempts);
      * a commit group materializes its members' shards, padded to the
        cohort size with the first member under a zero mask;
      * EF rows live in the bounded hot set (``feedback.BoundedMemory``),
        gathered for the group and scattered back for real members only.

    The round function takes the cohort first: ``round_fn(cohort, state,
    memory, key, mask, codec_key)``. With the full scheduler, no dropout
    and a full quorum the whole population is one cohort with
    ``mask=None``, bit-identical to ``PopulationCommSession``. A
    departed client's landed upload returns it to the pool.
    ``client_mesh`` splits each group's padded cohort over ranks, as
    ``PopulationCommSession`` splits its cohorts (every block one width).
    """

    def __init__(self, config, population, *, keys: torch.Tensor,
                 state0: Any = None, mask_dtype: torch.dtype = torch.float64,
                 device: "str | torch.device" = "cuda",
                 obs=NULL_TELEMETRY, client_mesh=None):
        super().__init__(config, population.m, population.client_weights,
                         keys=keys, state0=state0, mask_dtype=mask_dtype,
                         device=device, obs=obs)
        self.population = population
        self.client_mesh = client_mesh
        self.cohort_size = config.scheduler.cohort_size(population.m)
        # the quorum counts against what can be in flight: one cohort
        if config.buffer_size is not None:
            self.quorum = min(self.cohort_size, int(config.buffer_size))
        else:
            self.quorum = max(1, min(self.cohort_size, int(math.ceil(
                config.async_quantile * self.cohort_size))))
        dyn = config.dynamics
        self.lockstep = (config.scheduler.is_full
                         and config.channel.dropout_prob == 0.0
                         and self.quorum == self.m
                         and (dyn is None or not dyn.forces_mask))
        self.ef_store = (feedback.BoundedMemory(ef_capacity(
            config, self.m, self.cohort_size))
            if config.has_error_feedback else None)
        # event bookkeeping O(in flight), never O(m)
        self._in_flight: set = set()
        self._pending_down = defaultdict(float)  # id -> broadcast bytes
        self._pending_dropped: Dict[int, bool] = {}  # ids lost this window
        self._attempt = 0  # coin redraws of the current version's cohort

    def prepare(self, round_fn) -> None:
        """The probe round runs on a cohort of the cohort size."""
        mask = (None if self.lockstep else torch.ones(
            self.cohort_size, dtype=self._mask_dtype, device=self._device))
        probe_ids = np.zeros(self.cohort_size, dtype=np.int64)
        probe = self._cohort(probe_ids)
        self._probe(lambda s, mem, k, msk, ck: round_fn(probe, s, mem, k, msk,
                                                        ck),
                    self._pack_threat(mask, probe_ids))
        if self._state0 is not None:
            self.start(self._state0)

    def start(self, state) -> None:
        self._snapshots[0] = state
        self._dispatch_cohort((), now=0.0)

    def _dispatch_cohort(self, clients, now: float) -> None:
        """Sample the current version's cohort and refill the flights up
        to the cohort size (``clients`` is ignored: population clients
        are anonymous between cycles). The cap keeps one cohort in the
        air, as the dense driver re-dispatches only landed clients."""
        budget = self.cohort_size - len(self._in_flight)
        if budget <= 0:
            return
        k_sched, k_chan, _ = round_keys(self.config.seed, self.version)
        eligible = apply_churn(self, self.version)
        chan = self.config.channel_at(self.version)
        ids = self.config.scheduler.sample_ids(k_sched, self.version, self.m,
                                               chan, eligible=eligible)
        cohort = np.asarray(
            [j for j in ids if int(j) not in self._in_flight][:budget],
            dtype=np.int64)
        if cohort.size == 0:
            return
        attempt = self._attempt
        self._attempt += 1
        if attempt:
            # the version's previous dispatch all dropped: redraw the
            # coins, forcing delivery once the attempts are spent
            k_chan = fold_in(k_chan, attempt)
        draw = chan.draw_for(k_chan, cohort)
        if attempt >= MAX_RETRIES:
            draw = dataclasses.replace(draw,
                                       dropout=np.zeros_like(draw.dropout))
        times = chan.client_times_for(
            cohort, self.m, draw,
            np.full(cohort.size, float(self.bytes_up_per_client)),
            np.full(cohort.size, float(self.bytes_down_per_client)))
        for i, j in enumerate(cohort):
            j = int(j)
            self._in_flight.add(j)
            self._launch(j, now, float(times[i]), bool(draw.straggler[i]),
                         bool(draw.dropout[i]), retry=attempt)

    def _redispatch(self, j: int, now: float, retry: int) -> None:
        """A dropped upload landed: the client returns to the pool (the
        next version replaces it)."""
        self._in_flight.discard(j)
        if not self._heap and not self._buffer:
            # every upload in the air dropped: redraw this version's cohort
            self._dispatch_cohort((), now=now)

    def _retire_flight(self, flight: _Flight, now: float) -> None:
        """A departed client's upload landed: back to the pool (the next
        dispatch samples a replacement among the alive)."""
        self._pending_dropped[flight.client] = True
        self._in_flight.discard(flight.client)
        if not self._heap and not self._buffer:
            self._dispatch_cohort((), now=now)

    def _retire_ef(self, departed: np.ndarray) -> None:
        """Departed clients leave the EF hot set (``BoundedMemory.retire``)."""
        if self.ef_store is not None:
            self.ef_store.retire(departed)

    def step(self, round_fn) -> Any:
        """A population commit: each group materializes its members."""
        commit_time = self._pump()
        committed, self._buffer = self._buffer, []
        if self.obs.enabled:
            self._observe_commit(committed, commit_time)
        groups, order = self._groups(committed)
        outputs: Dict[int, Any] = {}
        for v in order:
            members = groups[v]
            # a fixed-width cohort: the first member pads under a zero mask
            padded = members + [members[0]] * (self.cohort_size - len(members))
            cohort = self._cohort(np.asarray(padded))
            memory = self.ef_store.gather(padded) if self.ef_store else {}
            _, _, k_codec = round_keys(self.config.seed, v)
            self._group_version = v
            mask = self._mask(self.cohort_size, slice(0, len(members)))
            outputs[v], mem_out, stats = round_fn(
                cohort, self._snapshots[v], self._memory_in(cohort, memory),
                self.keys[v], self._pack_threat(mask, np.asarray(padded)),
                k_codec)
            self._consume_stats(stats)
            if self.ef_store is not None:
                self.ef_store.scatter(members,
                                      self._memory_out(cohort, mem_out))
        state_new = self._combine(groups, order, outputs)
        self._record_trace(committed, commit_time)
        for client, _, _, _ in committed:
            self._in_flight.discard(client)
        self._attempt = 0
        self._advance(state_new, commit_time)
        self._dispatch_cohort((), now=commit_time)
        return state_new

    def _record_trace(self, committed, commit_time: float) -> None:
        down = dict(self._pending_down)
        dropped = set(self._pending_dropped)
        ids = sorted({c for c, _, _, _ in committed} | dropped | set(down))
        index = {cid: i for i, cid in enumerate(ids)}
        n = len(ids)
        delivered = np.zeros(n, dtype=bool)
        straggler = np.zeros(n, dtype=bool)
        stale = np.full(n, np.nan)
        for client, version, was_straggler, _ in committed:
            i = index[client]
            delivered[i] = True
            straggler[i] = was_straggler
            stale[i] = float(self.version - version)
        scheduled = delivered.copy()
        for cid in dropped:
            scheduled[index[cid]] = True
        self.traces.append(RoundTrace(
            round=self.version,
            scheduled=scheduled,
            delivered=delivered,
            straggler=straggler,
            bytes_up=(float(self.bytes_up_per_client)
                      * delivered.astype(np.float64)),
            bytes_down=np.asarray([down.get(cid, 0.0) for cid in ids]),
            sim_time_s=commit_time - self.server_clock,
            staleness=stale,
            version=self.version + 1,
            ids=np.asarray(ids, dtype=np.int64),
            population=self.m,
        ))
        self._count_corrupted(delivered, self.traces[-1].ids)
        if self.obs.enabled:
            self._observe_trace(self.traces[-1], len(dropped))
        self._pending_down = defaultdict(float)
        self._pending_dropped = {}

    def _observe_ef(self) -> None:
        observe_ef_store(self.obs, self.ef_store)

    def ef_residual_norms(self) -> Dict[str, float]:
        return self.ef_store.residual_norms() if self.ef_store else {}
