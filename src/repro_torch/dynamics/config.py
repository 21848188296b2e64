"""``DynamicsConfig``: the one knob that threads scenario dynamics
through ``CommConfig``.

Counterpart of ``repro.dynamics.config``. ``CommConfig(dynamics=
DynamicsConfig(...))`` composes up to four independent layers: churn, a
time-varying channel process, a Byzantine threat model and a robust
aggregation chain. Each takes a spec string (parsed by the layer's
``make_*``) or a constructed object; ``None`` (the default everywhere)
turns the layer off. An all-``None`` config is *null* and ``CommConfig``
normalizes it away, so the code paths without dynamics stay unchanged.

``seed`` feeds every layer given as a spec string: churn lifetimes and
the attacker subset derive their per-id draws from it (objects passed
directly, a ``ChannelProcess`` among them, keep their own seeds).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.dynamics.churn import ChurnProcess, make_churn
from repro_torch.dynamics.process import ChannelProcess
from repro_torch.dynamics.robust import RobustAggregator, make_aggregator
from repro_torch.dynamics.threat import ThreatModel, make_threat


@dataclasses.dataclass
class DynamicsConfig:
    """Scenario-dynamics description (see the module docstring).

    ``churn`` — ``"step:t=T[,frac=f]" | "poisson:rate" |
    "lifetime:mean[,stagger]"`` or a ``ChurnProcess``;
    ``channel`` — a ``ChannelProcess`` (field multiplier specs and an
    optional ``outage="outage:p,dur[,groups]"``);
    ``threat`` — ``"signflip:f" | "scale:f[,c]" | "noise:f[,s]"`` or a
    ``ThreatModel``;
    ``robust`` — ``"clip:tau" | "trimmed:f" | "median"``
    (``"+"``-chainable) or a ``RobustAggregator``.
    """

    churn: "str | ChurnProcess | None" = None
    channel: "ChannelProcess | None" = None
    threat: "str | ThreatModel | None" = None
    robust: "str | RobustAggregator | None" = None
    seed: int = 0

    def __post_init__(self):
        if self.churn is not None:
            self.churn = make_churn(self.churn, seed=self.seed)
        if self.channel is not None and not isinstance(
                self.channel, ChannelProcess):
            raise ValueError(
                f"DynamicsConfig.channel wants a ChannelProcess, got "
                f"{self.channel!r} — field multipliers need to be named "
                f"(e.g. ChannelProcess(uplink_bytes_per_s='sin:24,0.5'))")
        if self.threat is not None:
            self.threat = make_threat(self.threat, seed=self.seed)
        if self.robust is not None:
            self.robust = make_aggregator(self.robust)

    @property
    def is_null(self) -> bool:
        """No layer active: behave exactly as if dynamics were None."""
        return (self.churn is None and self.channel is None
                and self.threat is None and self.robust is None)

    @property
    def forces_mask(self) -> bool:
        """Churn and outages invalidate the statically full paths: the
        delivery mask must go to the round even under a full scheduler
        with no iid dropout."""
        return (self.churn is not None
                or (self.channel is not None and self.channel.has_outage))

    def describe(self) -> "dict[str, Any]":
        """JSON-friendly summary for benchmark and example records."""
        return {
            "churn": getattr(self.churn, "__class__", type(None)).__name__
            if self.churn is not None else None,
            "channel": dataclasses.asdict(self.channel)
            if self.channel is not None else None,
            "threat": (f"{self.threat.kind}:{self.threat.fraction}"
                       + (f"@{'+'.join(self.threat.payloads)}"
                          if self.threat.payloads else ""))
            if self.threat is not None else None,
            "robust": self.robust.name if self.robust is not None else None,
        }
