"""Federated optimizer interface, PRNG keys and the round loop.

Counterpart of ``repro.core.base``. Every algorithm implements

  * ``init(problem, w0) -> state``          (a dict of tensors)
  * ``round(problem, state, key, comm=None) -> state``   (one round;
      payloads go through ``comm.uplink``/``comm.downlink``, weights
      through ``comm.weights``; ``comm=None`` is the no-transport path)
  * ``uplink_floats(problem)`` / ``downlink_floats(problem)``.

``run_rounds(..., comm=CommConfig(...))`` threads the simulated
transport (``repro_torch.comm``) through every round: codecs with exact
encoded bytes both ways, the channel's simulated wall-clock, the
scheduler's cohort and error feedback, on the synchronous clock or
(``async_mode=True``) the event-driven one, where ``sim_time_s`` is the
server clock and ``History.staleness`` each commit's mean lag. The
problem may be a ``ClientPopulation``: each round then materializes only
its cohort. The loop is the same for every mode: ``make_session``
resolves ``comm`` (and the population) to a ``Session``.
``run_rounds(..., obs=TelemetryConfig(...))`` turns on the telemetry
layer (``repro_torch.obs``).

Keys. JAX's threefry keys become two pieces (``repro_torch.keys``):
``root_key`` mints a ``torch.Generator`` on the device from an integer
seed, and a *key* is one round's seed material, an int32 tensor of shape
(2,) on the host (8 bytes, the size of a JAX ``uint32[2]`` key, so the
``seed`` broadcast bills the same bytes). ``split`` draws keys from a
generator, ``key_from_ints`` derives a key on the host, and
``generator`` turns a key into a generator on a device. Keys live on the
host, so deriving the round's generator needs no device sync.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.comm import make_session
from repro_torch.comm.metrics import RoundTrace
from repro_torch.device import resolve_device
from repro_torch.keys import key_bits, key_from_ints
from repro_torch.obs import NULL_TELEMETRY, Telemetry, TelemetryConfig
from repro_torch.obs import log as obs_log

OptState = Dict[str, Any]


def root_key(seed: int, *salts: int,
             device: "str | torch.device" = "cuda") -> torch.Generator:
    """Mint a trajectory root generator on ``device`` from an integer
    seed: the one place library code turns a raw integer into random
    state. Extra ``salts`` give disjoint deterministic streams."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(key_bits(key_from_ints(seed, *salts)))
    return gen


def split(gen: torch.Generator, num: int) -> torch.Tensor:
    """``num`` keys, (num, 2) int32 on the host, drawn from ``gen``."""
    words = torch.randint(0, 2**31 - 1, (num, 2), generator=gen,
                          device=gen.device, dtype=torch.int64)
    return words.to(device="cpu", dtype=torch.int32)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b (batched over leading axes) without the singularity check
    that would wait on the device."""
    return torch.linalg.solve_ex(a, b)[0]


def build_round(opt: "FederatedOptimizer", problem, session, *,
                population=None):
    """The round function every session drives: ``_round(state, memory,
    key, mask, codec_key) -> (state, memory_out, stats_out)``, or with a
    ``population`` ``_round(cohort, state, memory, key, mask, codec_key)``
    (the materialized cohort is the round's problem). The session builds
    the round's transport view from the EF memory, the delivery mask and
    the codec key; without error feedback the memory stays an empty
    dict, and without robust aggregation the stats (device scalars) do."""
    if population is not None:
        def _round(cohort, state, memory, key, mask, codec_key):
            cr = session.comm_round(memory, mask, codec_key,
                                    block=cohort.block)
            state = opt.round(cohort, state, key, comm=cr)
            return state, cr.memory_out, cr.stats_out
        return _round

    def _round(state, memory, key, mask, codec_key):
        cr = session.comm_round(memory, mask, codec_key)
        state = opt.round(problem, state, key, comm=cr)
        return state, cr.memory_out, cr.stats_out
    return _round


def _check_async_policy(opt, comm) -> None:
    """The asynchronous driver prices uploads at dispatch, so an
    adaptive-k policy (round-varying payload sizes) is refused; a
    rotating basis with EF warns (stale groups share the new epoch's
    memory)."""
    policy = getattr(opt, "policy", None)
    if comm is None or not comm.async_mode or policy is None:
        return
    if getattr(policy, "adaptive", False):
        raise NotImplementedError(
            "adaptive-k sketch policies vary payload bytes per round, "
            "which the asynchronous driver cannot bill truthfully "
            "(in-flight uploads are priced at dispatch time); use the "
            "synchronous driver or a constant-k policy")
    if (getattr(policy, "schedule", "fresh") == "rotate"
            and comm.has_error_feedback):
        obs_log.warn_with_context(
            "async driver + rotating sketch policy + error feedback: "
            "commit groups based on pre-rotation model versions share the "
            "EF memory of the new epoch, so residuals can briefly straddle "
            "a rotation boundary under stale commits; the synchronous "
            "driver keeps the epoch-reset invariant exact",
            category=RuntimeWarning, stacklevel=3, optimizer=opt.name,
            policy=policy.spec())


class FederatedOptimizer:
    name: str = "base"

    def init(self, problem, w0: torch.Tensor) -> OptState:
        return {"w": w0}

    def round(self, problem, state: OptState, key: torch.Tensor,
              comm=None) -> OptState:
        raise NotImplementedError

    def round_signature(self, round_idx: int, state: OptState):
        """Host-side pre-round hook: a hashable signature naming the
        static variant of the next round. Rounds sharing a signature
        share one payload byte plan; a new one re-bills. Default: one
        signature (``None``) for the whole trajectory."""
        return None

    def uplink_floats(self, problem) -> int:
        raise NotImplementedError

    def downlink_floats(self, problem) -> int:
        return problem.dim


@dataclasses.dataclass
class History:
    """Per-round trajectory of one optimizer on one problem (the fields
    and JSONL schema of ``repro.core.base.History``)."""

    name: str
    loss: np.ndarray  # (T+1,) global loss, loss[0] at w0
    gap: np.ndarray  # (T+1,) loss - loss(w*)
    grad_norm: np.ndarray  # (T+1,)
    uplink_floats: int  # per client per round
    downlink_floats: int
    wall_time_s: float
    rounds: int
    cumulative_bytes: Optional[np.ndarray] = None  # (T+1,) up+down, all clients
    sim_time_s: Optional[np.ndarray] = None  # (T+1,) cumulative simulated s
    traces: Optional[list] = None  # per-round records (transport runs)
    staleness: Optional[np.ndarray] = None
    clients: int = 1
    itemsize: int = 8
    ef_residuals: Optional[dict] = None
    telemetry: Optional[dict] = None

    _JSONL_SCHEMA = "repro.history/v1"

    def to_jsonl(self, path) -> pathlib.Path:
        """Write this trajectory as JSONL: one ``history`` header line,
        then one ``round_trace`` line per ``RoundTrace``."""

        def arr(a):
            if a is None:
                return None
            return [None if (isinstance(v, float) and not np.isfinite(v))
                    else v
                    for v in np.asarray(a, dtype=np.float64).tolist()]

        header = {
            "type": "history",
            "schema": self._JSONL_SCHEMA,
            "name": self.name,
            "rounds": int(self.rounds),
            "uplink_floats": int(self.uplink_floats),
            "downlink_floats": int(self.downlink_floats),
            "wall_time_s": float(self.wall_time_s),
            "clients": int(self.clients),
            "itemsize": int(self.itemsize),
            "loss": arr(self.loss),
            "gap": arr(self.gap),
            "grad_norm": arr(self.grad_norm),
            "cumulative_bytes": arr(self.cumulative_bytes),
            "sim_time_s": arr(self.sim_time_s),
            "staleness": arr(self.staleness),
            "ef_residuals": self.ef_residuals,
            "telemetry": self.telemetry,
        }
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            f.write(json.dumps(header, allow_nan=False) + "\n")
            for tr in self.traces or []:
                f.write(json.dumps({"type": "round_trace", **tr.to_dict()},
                                   allow_nan=False) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path) -> "History":
        """Read a ``History`` JSONL file (``repro.history/v1``), with its
        per-round ``RoundTrace`` records."""

        def arr(v):
            if v is None:
                return None
            return np.asarray([np.nan if x is None else x for x in v],
                              dtype=np.float64)

        with pathlib.Path(path).open() as f:
            lines = [json.loads(line) for line in f if line.strip()]
        if not lines or lines[0].get("type") != "history":
            raise ValueError(f"{path}: not a History JSONL (missing header)")
        h = lines[0]
        if h.get("schema") != cls._JSONL_SCHEMA:
            raise ValueError(
                f"{path}: schema {h.get('schema')!r} != "
                f"{cls._JSONL_SCHEMA!r}")
        traces = [RoundTrace.from_dict(rec) for rec in lines[1:]
                  if rec.get("type") == "round_trace"]
        return cls(
            name=h["name"],
            loss=arr(h["loss"]),
            gap=arr(h["gap"]),
            grad_norm=arr(h["grad_norm"]),
            uplink_floats=int(h["uplink_floats"]),
            downlink_floats=int(h["downlink_floats"]),
            wall_time_s=float(h["wall_time_s"]),
            rounds=int(h["rounds"]),
            cumulative_bytes=arr(h["cumulative_bytes"]),
            sim_time_s=arr(h["sim_time_s"]),
            traces=traces or None,
            staleness=arr(h["staleness"]),
            clients=int(h["clients"]),
            itemsize=int(h["itemsize"]),
            ef_residuals=h.get("ef_residuals"),
            telemetry=h.get("telemetry"),
        )


class _ProfilerHook:
    """Opt-in ``torch.profiler`` recording around the first N executed
    rounds (``TelemetryConfig.profile_rounds``), CPU and, on a CUDA
    device, CUDA activity; a Chrome trace is exported into
    ``profile_dir`` when it stops. Host-side start/stop only: the rounds
    run the code they always run."""

    def __init__(self, obs: "TelemetryConfig | None", rounds: int,
                 device: torch.device):
        self._remaining = 0
        self._prof = None
        if obs is None or obs.profile_rounds <= 0 or rounds <= 0:
            return
        from torch.profiler import ProfilerActivity, profile

        self._dir = pathlib.Path(obs.profile_dir)
        self._label = re.sub(r"[^\w.+-]+", "_", obs.label) or "run"
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # profiler backend unavailable: degrade
            obs_log.warn_with_context(
                f"torch.profiler trace hook unavailable ({e!r}); continuing "
                f"without a device trace", profile_dir=obs.profile_dir)
            return
        self._prof = prof
        self._remaining = min(int(obs.profile_rounds), rounds)
        obs_log.info("torch.profiler trace started",
                     profile_dir=obs.profile_dir, rounds=self._remaining)

    def after_round(self) -> None:
        if self._remaining > 0:
            self._remaining -= 1
            if self._remaining == 0:
                self._stop()

    def close(self) -> None:
        """Stop a still-open trace (fewer executed rounds than asked)."""
        if self._remaining > 0:
            self._remaining = 0
            self._stop()

    def _stop(self) -> None:
        from torch.autograd import DeviceType

        prof, self._prof = self._prof, None
        prof.stop()
        self._dir.mkdir(parents=True, exist_ok=True)
        path = self._dir / (f"{self._label}_{os.getpid()}_"
                            f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        # one line: the kernels by device time, or on the CPU the ops by
        # their own host time
        rows = prof.key_averages()
        cuda = [e for e in rows if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if cuda:
            top = sorted(cuda, key=lambda e: -e.self_device_time_total)
            times = [e.self_device_time_total for e in top]
        else:
            top = sorted(rows, key=lambda e: -e.self_cpu_time_total)
            times = [e.self_cpu_time_total for e in top]
        summary = "; ".join(f"{e.key[:60]} x{e.count} {us / 1e3:.3f} ms"
                            for e, us in zip(top[:8], times))
        obs_log.info("torch.profiler trace written", path=str(path),
                     kernels=summary)


def run_rounds(
    opt: FederatedOptimizer,
    problem,
    w0: torch.Tensor,
    w_star: torch.Tensor,
    rounds: int,
    seed: int = 0,
    comm=None,
    obs=None,
    client_mesh=None,
) -> History:
    """Drive ``rounds`` communication rounds and record the trajectory.

    Runs on the device the problem lives on. ``comm=None`` is the
    no-transport path; a ``CommConfig`` runs every round (or commit,
    with ``async_mode=True``) through the simulated transport, and the
    ``History`` then carries one ``RoundTrace`` per round and the final
    EF memory norms. ``problem`` may be a ``ClientPopulation``: only the
    scheduled cohort is materialized each round, a ``CommConfig`` is
    required, loss and gradient come from ``problem.eval_problem()``, and
    optimizers with dense per-client state (``per_client_state``, FedNew's
    duals) are refused. ``client_mesh`` (a ``DeviceMesh`` over the
    ranks of an initialised process group, every rank calling
    ``run_rounds`` alike) splits each cohort of a population over the
    ranks of its client axis (``sharding.rules.cohort_block``): each rank
    materializes and runs its block, the transport gathers the decoded
    payloads, and every rank takes the same server step; a dense problem
    is not split. The round itself never waits on the device; the
    loop reads the loss and gradient norm back once per round.

    ``obs=TelemetryConfig(...)`` turns on the ``repro_torch.obs``
    telemetry layer: host-side spans (``prepare``, ``begin_variant``,
    ``step``, ``eval``, ``finalize``) around the session calls, never
    inside the round; the first execution of each round variant billed
    as ``compile_s`` and the rest as ``exec_s``; the sessions' metrics
    (bytes, deliveries, the staleness distribution, async queue depths)
    and the async flight recorder. With telemetry on and the state on a
    CUDA device the ``step`` span ends in ``torch.cuda.synchronize``, so
    it times the round's device work; with ``obs=None`` (the default)
    nothing waits and the trajectory is bit-identical either way. The
    run summary lands on ``History.telemetry``.
    """
    if obs is not None and not isinstance(obs, TelemetryConfig):
        raise TypeError(f"obs must be a repro_torch TelemetryConfig or None, "
                        f"got {type(obs).__name__}")
    telemetry = Telemetry(obs) if obs is not None else NULL_TELEMETRY
    population = problem if getattr(problem, "is_population", False) else None
    if population is not None:
        if getattr(opt, "per_client_state", False):
            raise NotImplementedError(
                f"{opt.name} keeps dense per-client state across rounds "
                f"(per_client_state=True); a population materializes only "
                f"the sampled cohort, so unsampled clients would carry "
                f"stale state: use a dense problem "
                f"(population.materialize_all()) or a stateless-client "
                f"optimizer")
        eval_prob = population.eval_problem()
        m = population.m
    else:
        eval_prob = problem
        m = problem.m
    dev = eval_prob.X.device
    itemsize = eval_prob.X.element_size()
    state = opt.init(eval_prob, w0)
    keys = split(root_key(seed, device=dev), rounds)
    weights = None
    if getattr(comm, "async_mode", False) and population is None:
        weights = problem.client_weights.cpu().numpy()
    session = make_session(comm, m=m, keys=keys, state0=state,
                           mask_dtype=eval_prob.X.dtype, device=dev,
                           population=population, client_weights=weights,
                           obs=telemetry, client_mesh=client_mesh)
    _check_async_policy(opt, comm)
    loss_star = float(eval_prob.global_value(w_star))
    _round = build_round(opt, problem, session, population=population)
    with telemetry.trace.span("prepare"):
        session.prepare(_round)

    def grad_norm(w):
        return float(torch.linalg.vector_norm(eval_prob.global_grad(w)))

    losses = [float(eval_prob.global_value(state["w"]))]
    gnorms = [grad_norm(state["w"])]
    # the first execution of each round variant is the "compile" round:
    # a new variant after the first counts as a retrace, as the
    # reference's one jax.jit per variant does
    seen: set = set()
    retraces = telemetry.metrics.counter("variant_retraces")
    settle = telemetry.enabled and dev.type == "cuda"
    profiler = _ProfilerHook(obs, rounds, dev)
    sig_prev = object()  # sentinel: no signature compares equal to it
    t0 = time.perf_counter()
    for t in range(rounds):
        sig = opt.round_signature(t, state)
        with telemetry.round(t, compile_expected=sig not in seen):
            if sig != sig_prev:
                with telemetry.trace.span("begin_variant"):
                    session.begin_variant(sig)
                sig_prev = sig
            if sig not in seen:
                if seen:
                    retraces.inc()
                seen.add(sig)
            with telemetry.trace.span("step"):
                state = session.step(_round)
                if settle:
                    # honest span timing: the round's device work ends
                    # inside the span (the values are unchanged)
                    torch.cuda.synchronize(dev)
            with telemetry.trace.span("eval"):
                losses.append(float(eval_prob.global_value(state["w"])))
                gnorms.append(grad_norm(state["w"]))
        profiler.after_round()
    wall = time.perf_counter() - t0
    profiler.close()
    with telemetry.trace.span("finalize"):
        transport = session.finalize()
    losses = np.asarray(losses)
    summary = telemetry.finalize(extra={
        "optimizer": opt.name,
        "driver": ("null" if comm is None
                   else "async" if comm.async_mode else "sync"),
        "rounds_requested": rounds,
        "clients": m,
        "total_bytes": (float(transport.cumulative_bytes[-1])
                        if len(transport.cumulative_bytes) else 0.0),
        "sim_time_s": (float(transport.sim_time_s[-1])
                       if len(transport.sim_time_s) else 0.0),
        "wall_time_s": wall,
    })
    return History(
        name=opt.name,
        loss=losses,
        gap=np.maximum(losses - loss_star, 0.0),
        grad_norm=np.asarray(gnorms),
        uplink_floats=opt.uplink_floats(eval_prob),
        downlink_floats=opt.downlink_floats(eval_prob),
        wall_time_s=wall,
        rounds=rounds,
        cumulative_bytes=transport.cumulative_bytes,
        sim_time_s=transport.sim_time_s,
        traces=transport.traces,
        staleness=transport.staleness,
        clients=m,
        itemsize=itemsize,
        ef_residuals=transport.ef_residuals,
        telemetry=summary,
    )
