"""Declarative sketch schedules: the ``SketchPolicy`` protocol.

Counterpart of ``repro.core.sketch_policy``. A policy is parsed from a
compact spec grammar::

    "srht"                      fresh SRHT basis every round (the default)
    "srht:fixed"                one basis for the whole trajectory
    "srht:rotate=8"             rotate the basis every 8 rounds
    "gaussian:adaptive"         adaptive-k (effective-dimension start,
                                guard-driven ramp within (k_min, k_max))
    "sjlt:rotate=4,seed=3"      options compose; ``seed`` picks the
                                basis stream for fixed/rotating bases
    "srht:adaptive=8..64"       explicit adaptive bounds k_min..k_max

and answers what a sketched optimizer needs: the round's operator
(``sample``/``materialize``), whether the basis persists across rounds
(``basis_persistent``, from which error-feedback eligibility flows), the
epoch reset of a rotating basis (``ef_reset``), and the k-schedule
(constant, or adaptive: ``resolved`` starts k at ``ceil(c * d_eff)``
clipped into the bounds, ``ramped`` doubles it toward ``k_max`` when the
FLeNS guard rejects a step).

Keys are the host-side keys of ``repro_torch.core.base``: a fresh
schedule uses the round's own key, a fixed or rotating one derives
its key from ``(seed, epoch)`` alone, which keeps the basis identical
across the rounds of an epoch. Policies are immutable; ``with_k`` /
``ramped`` / ``resolved`` return updated copies.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.sketch import (
    Sketch,
    effective_dimension,
    make_sketch,
    make_sketches,
)
from repro_torch.keys import key_from_ints

KINDS = ("srht", "gaussian", "sjlt")
SCHEDULES = ("fresh", "fixed", "rotate")


def adaptive_k(d_eff: float, *, c: float, k_min: int, k_max: int) -> int:
    """Dimension-efficient sketch size: ceil(c * d_eff) clipped into
    [k_min, k_max]."""
    return int(min(max(k_min, int(math.ceil(c * float(d_eff)))), k_max))


def loss_effective_dimension(problem, w0) -> float:
    """Effective dimension of the LOSS Hessian at ``w0`` (the ridge term
    excluded: it would inflate d_lambda by ~dim/2)."""
    h = problem.global_hessian(w0)
    eye = torch.eye(problem.dim, dtype=h.dtype, device=h.device)
    return float(effective_dimension(h - problem.lam * eye, problem.lam))


@dataclasses.dataclass(frozen=True)
class SketchPolicy:
    """A parsed, immutable sketch schedule (see module docstring)."""

    kind: str = "srht"
    schedule: str = "fresh"
    period: int = 0  # rotation period in rounds (schedule == "rotate")
    k: "int | None" = None  # current sketch size (None until bound)
    adaptive: bool = False
    k_min: "int | None" = None  # adaptive bounds; resolved() fills defaults
    k_max: "int | None" = None
    c: float = 2.0  # adaptive: k0 ~ ceil(c * d_eff)
    seed: int = 0  # basis stream for fixed/rotating schedules

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown sketch schedule {self.schedule!r}; "
                f"want one of {SCHEDULES}")
        if self.schedule == "rotate" and self.period < 1:
            raise ValueError(
                f"rotate schedule needs a period >= 1, got {self.period}")
        if (self.k_min is not None and self.k_max is not None
                and self.k_min > self.k_max):
            raise ValueError(
                f"adaptive bounds inverted: k_min={self.k_min} > "
                f"k_max={self.k_max}")

    # -- spec grammar --------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "SketchPolicy":
        """Parse ``kind[:opt[,opt]*]`` (grammar in the module docstring)."""
        kind, _, rest = spec.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown sketch kind {kind!r} in spec {spec!r}; "
                f"want one of {KINDS}")
        kw: dict = {"kind": kind}
        for raw in (o.strip() for o in rest.split(",")):
            if not raw:
                continue
            name, _, val = raw.partition("=")
            if name in ("fresh", "fixed"):
                kw["schedule"] = name
            elif name == "rotate":
                if not val:
                    raise ValueError(
                        f"rotate needs a period, e.g. 'rotate=8' (in {spec!r})")
                kw["schedule"] = "rotate"
                kw["period"] = int(val)
            elif name == "adaptive":
                kw["adaptive"] = True
                if val:
                    lo, sep, hi = val.partition("..")
                    if not sep:
                        raise ValueError(
                            f"adaptive bounds are 'adaptive=K_MIN..K_MAX', "
                            f"got {raw!r} (in {spec!r})")
                    kw["k_min"], kw["k_max"] = int(lo), int(hi)
            elif name == "seed":
                kw["seed"] = int(val)
            elif name == "c":
                kw["c"] = float(val)
            elif name == "k":
                kw["k"] = int(val)
            else:
                raise ValueError(
                    f"unknown sketch-policy option {raw!r} in spec {spec!r}")
        return cls(**kw)

    @classmethod
    def per_round(cls, basis: str) -> "SketchPolicy":
        """A fresh-schedule policy for a payload whose coordinate basis is
        re-derived every round without sampling a ``Sketch`` (FedNL's
        power-iteration eigenbasis): EF eligibility at such a call site
        flows from the same ``basis_persistent`` predicate."""
        return cls(kind=basis, schedule="fresh")

    # -- immutable updates ---------------------------------------------------
    def with_k(self, k: int) -> "SketchPolicy":
        return dataclasses.replace(self, k=int(k))

    def resolved(self, d_eff: float, cap: int) -> "SketchPolicy":
        """Resolve an adaptive k-schedule against a measured effective
        dimension: bounds default to (declared k, min(8 * k_min, cap)),
        and the starting k is ``adaptive_k`` inside them. No-op for
        constant-k policies."""
        if not self.adaptive:
            return self
        k_min = min(int(self.k_min or self.k or 8), int(cap))
        k_max = min(int(self.k_max or 8 * k_min), int(cap))
        k_max = max(k_max, k_min)
        k0 = adaptive_k(d_eff, c=self.c, k_min=k_min, k_max=k_max)
        return dataclasses.replace(self, k=k0, k_min=k_min, k_max=k_max)

    def ramped(self) -> "SketchPolicy":
        """One adaptive ramp step: double k toward ``k_max``."""
        if not self.adaptive or self.k_max is None:
            return self
        return self.with_k(min(2 * self.k, self.k_max))

    # -- the schedule --------------------------------------------------------
    def epoch(self, round_idx: int) -> int:
        """Basis epoch at ``round_idx``."""
        if self.schedule == "fixed":
            return 0
        if self.schedule == "rotate":
            return round_idx // self.period
        return round_idx

    def basis_persistent(self, round_idx: "int | None" = None) -> bool:
        """Does the basis at ``round_idx`` survive into the next round?
        ``None`` asks at the schedule level (any cross-round persistence
        at all). Adaptive-k never persists: a k change resizes the
        payload."""
        if self.adaptive or self.schedule == "fresh":
            return False
        if self.schedule == "fixed":
            return True
        if round_idx is None:
            return self.period > 1
        return (int(round_idx) + 1) % self.period != 0

    def ef_reset(self, round_idx: int) -> "bool | None":
        """True on the round a rotating basis is newly drawn (error
        feedback residuals of the old basis must be zeroed); ``None`` for
        schedules that never need it."""
        if self.schedule != "rotate" or self.period <= 1:
            return None
        return (round_idx % self.period) == 0

    def basis_key(self, key: torch.Tensor, round_idx: int) -> torch.Tensor:
        """The key the basis at ``round_idx`` is drawn from: the round's
        own key for a fresh schedule, a pure function of
        ``(seed, epoch)`` for a fixed or rotating one."""
        if self.schedule == "fresh":
            return key
        return key_from_ints(self.seed, self.epoch(round_idx))

    # -- operator construction -----------------------------------------------
    def materialize(self, key: torch.Tensor, dim: int,
                    dtype: torch.dtype = torch.float32,
                    device: "str | torch.device" = "cuda") -> Sketch:
        """Draw the operator from an already-derived basis key (e.g. the
        decoded ``down:seed`` broadcast)."""
        if self.k is None:
            raise ValueError(
                f"sketch policy {self.spec()!r} has no k bound; construct "
                f"the optimizer with k= or call with_k/resolved first")
        return make_sketch(key, self.kind, self.k, dim, dtype=dtype,
                           device=device)

    def materialize_batch(self, key: torch.Tensor, m: int, dim: int,
                          dtype: torch.dtype = torch.float32,
                          device: "str | torch.device" = "cuda") -> Sketch:
        """m operators, one per client, drawn from one basis key in one
        batched draw (``make_sketches``): a fresh schedule passes the
        round's key, a fixed or rotating one its ``(seed, epoch)`` key,
        so every client's basis is a pure function of it."""
        if self.k is None:
            raise ValueError(
                f"sketch policy {self.spec()!r} has no k bound; construct "
                f"the optimizer with k= or call with_k/resolved first")
        return make_sketches(key, self.kind, m, self.k, dim, dtype=dtype,
                             device=device)

    def sample(self, key: torch.Tensor, round_idx: int, dim: int,
               dtype: torch.dtype = torch.float32,
               device: "str | torch.device" = "cuda") -> Sketch:
        """The round's sketch operator: schedule-aware key, then draw."""
        return self.materialize(self.basis_key(key, round_idx), dim, dtype,
                                device)

    # -- display -------------------------------------------------------------
    def spec(self) -> str:
        """Round-trip the policy back to its spec string."""
        opts = []
        if self.schedule == "fixed":
            opts.append("fixed")
        elif self.schedule == "rotate":
            opts.append(f"rotate={self.period}")
        if self.adaptive:
            if self.k_min is not None and self.k_max is not None:
                opts.append(f"adaptive={self.k_min}..{self.k_max}")
            else:
                opts.append("adaptive")
        if self.seed:
            opts.append(f"seed={self.seed}")
        if self.c != 2.0:
            opts.append(f"c={self.c}")
        if self.k is not None:
            opts.append(f"k={self.k}")
        return self.kind + (":" + ",".join(opts) if opts else "")


def as_policy(spec: "str | SketchPolicy", k: "int | None" = None) -> SketchPolicy:
    """Coerce a spec string or policy to a ``SketchPolicy``, binding
    ``k`` when the policy does not already declare one."""
    pol = SketchPolicy.parse(spec) if isinstance(spec, str) else spec
    if not isinstance(pol, SketchPolicy):
        raise TypeError(f"want a spec string or SketchPolicy, got {pol!r}")
    if k is not None and pol.k is None:
        pol = pol.with_k(int(k))
    return pol
