"""repro_torch.dynamics on the population drivers, against repro.

``PopulationCommSession`` and ``PopulationAsyncSession`` on the
reference's 1000-client synthetic population
(``test_torch_population.synthetic``, its shards handed to the port) at
``uniform:0.01`` on the edge channel, with the reference's draws
injected and telemetry on, under each of the three scenarios of
``tests/test_torch_dynamics.py`` (split from it so each file stays near
a minute on one thread): churn with a diurnal channel and regional
outages under ``comp+sched+ef`` (cohorts drawn among the eligible ids,
departed clients' rows retired from the EF hot set), a sign-flip
coalition against the trimmed mean under the dense codecs, and a noise
attack on ``h_sk`` against clip and median under identity codecs. What
must match is ``test_torch_dynamics.check_dynamics_parity``'s.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dynamics import DRIVERS, PARITY_CASES, check_dynamics_parity
from test_torch_population import synthetic  # noqa: F401
from _torch_threads import worker_threads

torch.set_num_threads(worker_threads())

CASES = [c for c in PARITY_CASES if c[0] in DRIVERS[2:]]


@pytest.mark.parametrize("driver,scenario", CASES,
                         ids=[f"{d}-{s}" for d, s in CASES])
def test_population_dynamics_match_reference(driver, scenario, synthetic,
                                             monkeypatch):
    check_dynamics_parity(driver, scenario, None, synthetic, monkeypatch)
