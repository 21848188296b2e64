"""Scenario dynamics: churn, time-varying channels, threats, robustness.

Counterpart of ``repro.dynamics``. ``repro_torch.comm`` models a static,
honest population over a channel whose statistics never change. This
package composes three dynamic layers on top of it, threaded through
``CommConfig(dynamics=DynamicsConfig(...))``:

  * **population churn** (``churn``) — arrival and departure processes
    shrink and grow the eligible client ids the schedulers draw from;
  * **time-varying channels** (``process``) — a ``ChannelProcess`` over
    ``ChannelModel`` whose per-field multipliers follow diurnal cycles
    and drift, with correlated regional outages, keyed by ``(field,
    client_id, round)``;
  * **adversarial uploads and robust aggregation** (``threat``,
    ``robust``) — a ``ThreatModel`` corrupting a seeded subset of uplinks
    inside the round, and robust aggregators composed with the
    participation and staleness weights.

Every layer defaults off; a ``CommConfig`` without ``dynamics`` (or with
an all-``None`` ``DynamicsConfig``) runs the code paths it ran before,
bit for bit on every driver (tested).
"""
from repro_torch.dynamics.churn import (
    ChurnProcess,
    LifetimeChurn,
    PoissonChurn,
    StepChurn,
    make_churn,
)
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.dynamics.process import ChannelProcess
from repro_torch.dynamics.robust import (
    ChainAggregator,
    ClipAggregator,
    CoordinateMedian,
    RobustAggregator,
    TrimmedMean,
    make_aggregator,
)
from repro_torch.dynamics.threat import ThreatModel, make_threat

__all__ = [
    "ChainAggregator",
    "ChannelProcess",
    "ChurnProcess",
    "ClipAggregator",
    "CoordinateMedian",
    "DynamicsConfig",
    "LifetimeChurn",
    "PoissonChurn",
    "RobustAggregator",
    "StepChurn",
    "ThreatModel",
    "TrimmedMean",
    "make_aggregator",
    "make_churn",
    "make_threat",
]
