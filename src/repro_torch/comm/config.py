"""The no-transport view every optimizer round routes through.

Counterpart of ``repro.comm.config._NullComm``/``NULL_COMM``: with
``comm=None`` the comm-aware code path is the only code path, and every
payload passes through unchanged. ``CommConfig`` and the codec-carrying
``CommRound`` arrive with the synchronous-transport slice.
"""
from __future__ import annotations

# payload-name prefix that selects the downlink (server -> client)
# direction in the byte plan
DOWN = "down:"


class _NullComm:
    """No-transport stand-in: uplinks, downlinks and weights are the
    identity."""

    def uplink(self, name, x, ef_eligible=True, ef_reset=None):
        return x

    def downlink(self, name, x):
        return x

    def weights(self, p):
        return p


NULL_COMM = _NullComm()


def plan_bytes(plan: "dict[str, int]", *, down: bool) -> int:
    """Sum one direction of a payload byte plan (keys are payload
    occurrences; downlink occurrences carry the ``"down:"`` prefix)."""
    return int(sum(v for k, v in plan.items()
                   if k.startswith(DOWN) == down))
