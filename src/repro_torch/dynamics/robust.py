"""Robust server-side aggregation transforms for uplink payloads.

Counterpart of ``repro.dynamics.robust``. A robust aggregator transforms
the decoded, stacked ``(c, ...)`` uplink payload on its device; it runs
in ``CommRound.uplink`` AFTER the codec's decode (the server defends
itself with what it received) and BEFORE the optimizer's weighted
aggregation, so it composes with the participation weights
(``CommRound.weights`` renormalizes over the delivering cohort) and, in
the asynchronous driver, with the staleness weights: clip ->
trim/median -> staleness -> participation.

Aggregators (spec grammar, ``"+"``-chained left to right, parsed by
``make_aggregator``):

  * ``"clip:tau"`` — per-client norm clipping: row ``i`` is scaled by
    ``min(1, tau/||x_i||)``. Defeats scaled payloads; leaves sign flips
    (norm-preserving) alone.
  * ``"trimmed:f"`` — coordinate-wise trimmed mean: per coordinate the
    ``ceil(f*c)`` largest and smallest delivered values are discarded
    and every row becomes the mean of the survivors. The participation
    weights downstream sum to 1 over the cohort, so the weighted
    aggregate is the trimmed mean.
  * ``"median"`` — coordinate-wise median of the delivered rows.

Undelivered rows (the delivery mask) never count as extremes: they are
replaced by the delivered mean before the sort, so dropout cannot eat
the trim budget, and the median sorts them past every delivered value.
Row-replacing aggregators (trim, median) broadcast the aggregate back to
every row.

Each transform adds its counters (``uploads_clipped``,
``uploads_trimmed``) to the round's ``stats_out`` as device scalars; the
session reads them once a round. The median of an even count is the
mean of the two middle values, as ``jnp.median`` takes it (not
``torch.median``'s lower one), and the masked median indexes the sorted
rows with the delivered count on the device (no read to the host).
These are PyTorch functions (``torch.sort``,
``torch.linalg.vector_norm``): the reference computes them in jnp, with
no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

ROBUST_KINDS = ("clip", "trimmed", "median")


def _bump(stats: dict, key: str, value: torch.Tensor) -> None:
    stats[key] = stats[key] + value if key in stats else value


def _mask_col(mask, c: int, dtype) -> "torch.Tensor | None":
    """(c, 1) 0/1 delivery column, or None for a fully delivered cohort."""
    if mask is None:
        return None
    return mask.to(dtype).reshape(-1, 1)[:c]


class RobustAggregator:
    """Base: ``__call__(x, mask, stats) -> x_robust``."""

    name: str = "robust"

    def __call__(self, x, mask, stats: dict):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


@dataclasses.dataclass(frozen=True)
class ClipAggregator(RobustAggregator):
    """Per-client norm clipping to radius ``tau``."""

    tau: float = 1.0

    def __post_init__(self):
        if self.tau <= 0:
            raise ValueError(f"clip tau must be > 0, got {self.tau}")

    @property
    def name(self):
        return f"clip:{self.tau}"

    def __call__(self, x, mask, stats):
        c = x.shape[0]
        flat = x.reshape(c, -1)
        norms = torch.linalg.vector_norm(flat, dim=1)
        factor = torch.clamp(self.tau / torch.clamp(norms, min=1e-30),
                             max=1.0)
        clipped = (norms > self.tau).to(x.dtype)
        mcol = _mask_col(mask, c, x.dtype)
        if mcol is not None:
            clipped = clipped * mcol[:, 0]
        _bump(stats, "uploads_clipped", torch.sum(clipped))
        return x * factor.reshape((-1,) + (1,) * (x.ndim - 1))


@dataclasses.dataclass(frozen=True)
class TrimmedMean(RobustAggregator):
    """Coordinate-wise trimmed mean over the delivered rows."""

    fraction: float = 0.1

    def __post_init__(self):
        if not 0.0 < self.fraction < 0.5:
            raise ValueError(
                f"trimmed fraction must be in (0, 0.5), got {self.fraction}")

    @property
    def name(self):
        return f"trimmed:{self.fraction}"

    def _trims(self, c: int) -> int:
        k = max(1, int(math.ceil(self.fraction * c)))
        if 2 * k >= c:  # tiny cohorts: keep at least one survivor
            k = (c - 1) // 2
        return k

    def __call__(self, x, mask, stats):
        c = x.shape[0]
        k = self._trims(c)
        flat = x.reshape(c, -1)
        mcol = _mask_col(mask, c, x.dtype)
        if mcol is not None:
            # undelivered rows -> the delivered mean: never an extreme,
            # so dropout cannot consume the trim budget
            n_del = torch.clamp(torch.sum(mcol), min=1.0)
            mean_del = torch.sum(flat * mcol, dim=0, keepdim=True) / n_del
            flat = mcol * flat + (1 - mcol) * mean_del
        if k == 0:
            agg = torch.mean(flat, dim=0, keepdim=True)
            _bump(stats, "uploads_trimmed",
                  torch.zeros((), dtype=x.dtype, device=x.device))
        else:
            srt = torch.sort(flat, dim=0).values
            agg = torch.mean(srt[k:c - k], dim=0, keepdim=True)
            lo, hi = srt[k:k + 1], srt[c - k - 1:c - k]
            out = ((flat < lo) | (flat > hi)).to(x.dtype)
            if mcol is not None:
                out = out * mcol
            # row-equivalents trimmed: coordinate trims / coordinates
            _bump(stats, "uploads_trimmed", torch.sum(out) / flat.shape[1])
        return agg.expand(flat.shape).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class CoordinateMedian(RobustAggregator):
    """Coordinate-wise median over the delivered rows."""

    name = "median"

    def __call__(self, x, mask, stats):
        c = x.shape[0]
        flat = x.reshape(c, -1)
        mcol = _mask_col(mask, c, x.dtype)
        srt_src = flat if mcol is None else torch.where(
            mcol > 0, flat, torch.full_like(flat, math.inf))
        srt = torch.sort(srt_src, dim=0).values
        if mcol is None:
            agg = 0.5 * (srt[(c - 1) // 2] + srt[c // 2])[None, :]
        else:
            # the delivered count indexes the middle on the device: the
            # undelivered rows sorted to +inf past every delivered one
            n = torch.clamp(torch.sum(mcol[:, 0]).to(torch.int64), min=1)
            lo = torch.index_select(srt, 0, ((n - 1) // 2).reshape(1))
            hi = torch.index_select(srt, 0, (n // 2).reshape(1))
            agg = 0.5 * (lo + hi)
        return agg.expand(flat.shape).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class ChainAggregator(RobustAggregator):
    """Left-to-right composition of robust transforms."""

    stages: "tuple[RobustAggregator, ...]" = ()

    @property
    def name(self):
        return "+".join(s.name for s in self.stages)

    def __call__(self, x, mask, stats):
        for stage in self.stages:
            x = stage(x, mask, stats)
        return x


def make_aggregator(
        spec: "str | RobustAggregator") -> RobustAggregator:
    """Parse ``"clip:tau" | "trimmed:f" | "median"`` (``"+"``-chainable,
    e.g. ``"clip:5+trimmed:0.1"``) or pass an aggregator through."""
    if isinstance(spec, RobustAggregator):
        return spec
    known = "clip:tau, trimmed:f, median"
    stages = []
    for part in str(spec).split("+"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        if kind not in ROBUST_KINDS:
            raise ValueError(
                f"unknown robust aggregator {part!r} in {spec!r}; "
                f"expected one of {known}")
        try:
            if kind == "clip":
                stages.append(ClipAggregator(tau=float(rest or 1.0)))
            elif kind == "trimmed":
                stages.append(TrimmedMean(fraction=float(rest or 0.1)))
            else:
                if rest:
                    raise ValueError(
                        f"median takes no parameters, got {part!r}")
                stages.append(CoordinateMedian())
        except ValueError as e:
            if e.args and ("must be" in str(e) or "takes no" in str(e)):
                raise
            raise ValueError(
                f"bad parameters in robust aggregator {part!r} (spec "
                f"{spec!r}); expected one of {known}") from e
    if not stages:
        raise ValueError(
            f"empty robust aggregator spec {spec!r}; expected one of {known}")
    if len(stages) == 1:
        return stages[0]
    return ChainAggregator(stages=tuple(stages))
