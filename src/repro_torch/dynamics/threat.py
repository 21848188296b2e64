"""Byzantine threat model: seeded clients corrupt their uplinks.

Counterpart of ``repro.dynamics.threat``. A ``ThreatModel`` marks a
deterministic, seeded subset of client ids as attackers (a pure per-id
function, so the same clients attack in every driver and at any cohort
composition) and corrupts their uplink payloads inside the round,
BEFORE the codec runs: an attacker crafts what it puts on the wire, so
compression and error feedback see the corrupted payload as they would
an honest one. Downlinks are never corrupted (the server is honest).

Attack kinds (spec grammar ``"kind:fraction[,param][@payloads]"``,
parsed by ``make_threat``):

  * ``"signflip:f"`` — attackers send ``-x`` (norm-preserving, so norm
    clipping alone cannot filter it);
  * ``"scale:f,c"`` — attackers send ``c * x`` (``c`` 10 by default);
  * ``"noise:f,s"`` — attackers replace the payload with ``N(0, s^2)``
    noise (``s`` 1 by default).

The ``@p1+p2`` suffix restricts the attack to the named payloads
(``"signflip:0.2@h_sk"`` corrupts only the Hessian sketch); without it
every uplink of an attacker is corrupted, scalar control payloads too.

The attacker coins come from ``_attacker_coins`` (the port's counter
draw, not the reference's threefry stream). The ``noise`` kind's normals
are the round's: ``CommRound.threat_noise`` draws them on the payload's
device and hands them to ``corrupt``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.comm.channel import _unit

THREAT_KINDS = ("signflip", "scale", "noise")

_THREAT_TAG = zlib.crc32(b"repro.dynamics.threat")

_DEFAULT_PARAM = {"signflip": 0.0, "scale": 10.0, "noise": 1.0}


def _attacker_coins(fraction: float, salt: int, ids: np.ndarray) -> np.ndarray:
    """(len(ids),) bool attacker coins, pure in ``(fraction, salt, id)``."""
    return _unit(salt, ids, 0) < fraction


@dataclasses.dataclass(frozen=True)
class ThreatModel:
    """Seeded Byzantine uplink corruption (see the module docstring)."""

    kind: str = "signflip"
    fraction: float = 0.1
    param: float = 0.0
    payloads: "tuple | None" = None
    seed: int = 0

    def __post_init__(self):
        if self.kind not in THREAT_KINDS:
            raise ValueError(
                f"unknown threat kind {self.kind!r}; expected one of "
                f"{', '.join(THREAT_KINDS)}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"threat fraction must be in [0, 1], got {self.fraction}")

    def applies(self, name: str) -> bool:
        """Does the attack touch the uplink payload ``name``?"""
        return self.payloads is None or name in self.payloads

    def attacker_mask(self, ids) -> np.ndarray:
        """(len(ids),) bool: is each client an attacker? Pure per id: the
        same ids attack in every cohort, round and driver."""
        ids = np.asarray(ids, dtype=np.int64)
        salt = (_THREAT_TAG ^ (self.seed & 0xFFFFFFFF)) & 0xFFFFFFFF
        return np.asarray(_attacker_coins(float(self.fraction), salt, ids),
                          dtype=bool)

    def corrupt(self, x: torch.Tensor, attackers: torch.Tensor,
                noise: "torch.Tensor | None" = None) -> torch.Tensor:
        """Corruption of a stacked ``(c, ...)`` uplink payload;
        ``attackers`` is the (c,) 0/1 attacker indicator, ``noise`` the
        round's N(0, 1) draw of ``x``'s shape (the ``noise`` kind only)."""
        a = attackers.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        if self.kind == "signflip":
            bad = -x
        elif self.kind == "scale":
            bad = x * self.param
        else:  # noise
            bad = self.param * noise
        return a * bad + (1 - a) * x


def make_threat(spec: "str | ThreatModel", seed: int = 0) -> ThreatModel:
    """Parse ``"kind:fraction[,param][@payload1+payload2]"`` or pass a
    ``ThreatModel`` through.

    The ``@`` suffix scopes the attack to the named uplink payloads
    (``ThreatModel.payloads``): every other uplink of an attacker stays
    its honest value. Without a suffix every uplink is corrupted.
    """
    if isinstance(spec, ThreatModel):
        return spec
    body, sep, scope = str(spec).partition("@")
    payloads = None
    if sep:
        payloads = tuple(p for p in scope.split("+") if p)
        if not payloads:
            raise ValueError(
                f"threat spec {spec!r} has an empty @payload scope; "
                f"drop the '@' to corrupt every uplink")
    kind, _, rest = body.partition(":")
    known = ", ".join(k + ":fraction" for k in THREAT_KINDS)
    if kind not in THREAT_KINDS:
        raise ValueError(
            f"unknown threat spec {spec!r}; expected one of {known}")
    try:
        params = tuple(float(p) for p in rest.split(",") if p != "")
    except ValueError:
        raise ValueError(
            f"bad parameters in threat spec {spec!r}; expected "
            f"'{kind}:fraction[,param][@payloads]'") from None
    if len(params) not in (1, 2):
        raise ValueError(
            f"threat spec {spec!r} wants 1-2 parameters "
            f"(fraction[, param]), got {len(params)}")
    param = params[1] if len(params) == 2 else _DEFAULT_PARAM[kind]
    return ThreatModel(kind=kind, fraction=params[0], param=param,
                       payloads=payloads, seed=seed)
