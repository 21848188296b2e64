"""Asynchronous FL on straggler-heavy edge links, on the PyTorch/CUDA port:
sync against async drivers.

The synchronous driver waits for the slowest delivering client every
round; with 30% stragglers at 10x the round clock belongs to the
unluckiest device. The asynchronous driver
(``repro_torch.comm.async_driver``) runs every client on its own clock
and commits once a quorum of uploads has arrived, weighting stale
contributions by 1/(1+tau). With a full quorum (full participation, no
dropout) it reproduces the synchronous trajectory bit for bit, which
this demo checks first. Then the three-driver race on one channel and
seed: lock-step sync, a FedBuff buffer (K = m/4, 4x the commits) and a
50% quorum (3x the commits).

The three race runs share one telemetry stream
(``obs=TelemetryConfig(sink="jsonl:...", label=<driver>)``): per-round
phase times, bytes, staleness histograms and the async flight events.
Telemetry leaves the trajectories bit-identical. Render it with::

  PYTHONPATH=src python -m repro_torch.obs.report results/examples/async_edge_torch_telemetry.jsonl

Run me::

  PYTHONPATH=src python examples/async_edge_torch.py                # on the card
  PYTHONPATH=src python examples/async_edge_torch.py --device cpu --rounds 6
"""
import argparse
import pathlib

import numpy as np
import torch

from repro_torch.comm import ChannelModel, CommConfig
from repro_torch.core import (
    logistic,
    make_optimizer,
    make_problem,
    newton_solve,
    run_rounds,
)
from repro_torch.data import load
from repro_torch.obs import TelemetryConfig


def straggler_edge_channel(m: int) -> ChannelModel:
    """Log-spaced uplinks across two decades (3e4-3e6 B/s), 10x faster
    downlinks, 50 ms latency, 30% stragglers at 10x, no dropout (which
    keeps the full-quorum anchor on the lock-step path)."""
    rates = np.logspace(np.log10(3e4), np.log10(3e6), m)
    return ChannelModel(uplink_bytes_per_s=rates,
                        downlink_bytes_per_s=10.0 * rates, latency_s=0.05,
                        straggler_prob=0.30, straggler_slowdown=10.0)


def loss_at(hist, t: float) -> float:
    """The loss at a simulated time (linear interpolation)."""
    return float(np.interp(t, hist.sim_time_s, hist.loss))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="phishing")
    ap.add_argument("--rounds", type=int, default=10, help="sync rounds")
    ap.add_argument("--buffer", type=int, default=None,
                    help="async buffer K (default m // 4)")
    ap.add_argument("--n-cap", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec, X, y = load(args.dataset, device=args.device)
    X, y = X[:args.n_cap], y[:args.n_cap]
    prob = make_problem(X, y, m=spec.m_clients, lam=1e-3, objective=logistic,
                        device=args.device)
    w0 = torch.zeros(prob.dim, dtype=torch.float64, device=args.device)
    w_star = newton_solve(prob, w0, iters=40)
    m = prob.m
    chan = straggler_edge_channel(m)

    def fedavg():
        return make_optimizer("fedavg", lr=2.0, local_steps=5)

    # the anchor: full-quorum async == sync, bit for bit
    sync = run_rounds(fedavg(), prob, w0, w_star, rounds=3,
                      comm=CommConfig(channel=chan, seed=1))
    asy = run_rounds(fedavg(), prob, w0, w_star, rounds=3,
                     comm=CommConfig(channel=chan, seed=1, async_mode=True))
    anchored = bool(np.array_equal(sync.loss, asy.loss)
                    and np.array_equal(sync.cumulative_bytes,
                                       asy.cumulative_bytes))
    print(f"full-quorum async reproduces sync bit-identically: {anchored}")
    assert anchored

    # the race: one channel, one seed, three drivers
    buf = args.buffer if args.buffer is not None else max(2, m // 4)
    runs = [("sync", args.rounds, CommConfig(channel=chan, seed=1)),
            ("async_buf", 4 * args.rounds,
             CommConfig(channel=chan, seed=1, async_mode=True,
                        buffer_size=buf, staleness="inverse")),
            ("async_q50", 3 * args.rounds,
             CommConfig(channel=chan, seed=1, async_mode=True,
                        async_quantile=0.5, staleness="inverse"))]
    # every driver appends to one telemetry stream, its records labelled
    # with the driver's name
    dest = pathlib.Path("results/examples")
    dest.mkdir(parents=True, exist_ok=True)
    telemetry_path = dest / "async_edge_torch_telemetry.jsonl"
    telemetry_path.unlink(missing_ok=True)  # the jsonl sink appends
    hists = {name: run_rounds(fedavg(), prob, w0, w_star, rounds=r, comm=comm,
                              obs=TelemetryConfig(
                                  sink=f"jsonl:{telemetry_path}", label=name))
             for name, r, comm in runs}
    print(f"\n=== {spec.name}: M={prob.dim} m={m} | 30% stragglers x10, "
          f"log-spaced uplinks ===")
    print(f"{'driver':>16} {'commits':>7} {'sim_s':>7} {'s/commit':>8} "
          f"{'loss_final':>10} {'mean_tau':>8}")
    for name, hist in hists.items():
        r = hist.rounds
        tau = (float(np.nanmean(hist.staleness))
               if hist.staleness is not None else 0.0)
        print(f"{name:>16} {r:>7d} {hist.sim_time_s[-1]:>7.2f} "
              f"{hist.sim_time_s[-1] / r:>8.3f} {hist.loss[-1]:>10.6f} "
              f"{tau:>8.2f}")

    print("\n--- loss at common simulated-time points ---")
    t_final = min(h.sim_time_s[-1] for h in hists.values())
    for frac in (0.25, 0.5, 1.0):
        row = "  ".join(f"{n}={loss_at(h, frac * t_final):.6f}"
                        for n, h in hists.items())
        print(f"t={frac * t_final:6.2f}s  {row}")
    best = min(hists, key=lambda n: loss_at(hists[n], t_final))
    if best == "sync":
        print(f"\nat t={t_final:.2f}s sync still leads on this channel/seed")
    else:
        margin = loss_at(hists["sync"], t_final) - loss_at(hists[best], t_final)
        print(f"\nat t={t_final:.2f}s the async drivers sit below sync by "
              f"{margin:.2e} loss (best: {best})")
    print(f"\nwrote {telemetry_path} (render with `python -m "
          f"repro_torch.obs.report {telemetry_path}`)")


if __name__ == "__main__":
    main()
