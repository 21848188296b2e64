"""repro_torch.dynamics on the dense transport drivers, against repro.

``CommSession`` and ``AsyncSession`` on the quickstart problem (n=4000,
dim=64, m=8, float64) with the reference's draws injected and telemetry
on, under each of the three scenarios of ``tests/test_torch_dynamics.py``
(split from it so each file stays near a minute on one thread): churn
with a diurnal channel and regional outages under ``comp+sched+ef``
(the sync driver on the edge channel with ``bandwidth:0.5``, the async
one on the straggler channel with 20% dropout and a buffer of 3), a
sign-flip coalition against the trimmed mean under the dense codecs,
and a noise attack on ``h_sk`` against clip and median under identity
codecs. What must match is ``test_torch_dynamics.check_dynamics_parity``'s:
losses to rtol 1e-9, traces exactly but the simulated time to rtol
1e-12, the robust counters, the dynamics counters and gauges and the
flight ``retire`` events exactly.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_comm import quickstart  # noqa: F401
from test_torch_dynamics import DRIVERS, PARITY_CASES, check_dynamics_parity
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

CASES = [c for c in PARITY_CASES if c[0] in DRIVERS[:2]]


@pytest.mark.parametrize("driver,scenario", CASES,
                         ids=[f"{d}-{s}" for d, s in CASES])
def test_dynamics_match_reference(driver, scenario, quickstart, monkeypatch):
    check_dynamics_parity(driver, scenario, quickstart, None, monkeypatch)
