"""Transport axes a ``Session`` hands back for ``History`` assembly
(counterpart of ``repro.comm.metrics.Transport``)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transport:
    """On the no-transport path the bytes curve comes from the round's
    identity-codec byte plan and simulated time is identically zero;
    the per-round traces, staleness and error-feedback axes come with
    the transport slices."""

    cumulative_bytes: np.ndarray  # (T+1,) up+down, all clients
    sim_time_s: np.ndarray  # (T+1,) cumulative simulated seconds
