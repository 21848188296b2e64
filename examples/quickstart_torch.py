"""Quickstart on the PyTorch/CUDA port: a Table-I optimizer on a synthetic
federated logistic-regression problem (8 clients, 64 features).

  PYTHONPATH=src python examples/quickstart_torch.py                 # flens, on the card
  PYTHONPATH=src python examples/quickstart_torch.py --algo fedns
  PYTHONPATH=src python examples/quickstart_torch.py --algo all --device cpu
"""
import argparse

import torch

from repro_torch.core import (
    ALGORITHMS,
    logistic,
    make_optimizer,
    make_problem,
    newton_solve,
    run_rounds,
)
from repro_torch.data import make_classification

# each optimizer's settings in examples/federated_logreg.py, k = M / 2
KWARGS = {"fedavg": dict(lr=2.0, local_steps=5),
          "fedprox": dict(lr=2.0, local_steps=5, mu_prox=0.01),
          "fedns": dict(k=32), "flens": dict(k=32), "flens_plus": dict(k=32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", default="flens", choices=(*ALGORITHMS, "all"))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    X, y = make_classification(0, n=4000, dim=64, device=args.device)
    problem = make_problem(X, y, m=8, lam=1e-3, objective=logistic,
                           device=args.device)
    w0 = torch.zeros(64, dtype=torch.float64, device=args.device)
    w_star = newton_solve(problem, w0)  # reference optimum
    for name in ALGORITHMS if args.algo == "all" else (args.algo,):
        hist = run_rounds(make_optimizer(name, **KWARGS.get(name, {})),
                          problem, w0, w_star, rounds=args.rounds)
        gaps = "  ".join(f"{g:.1e}" for g in hist.gap[::3])
        print(f"{hist.name:>18}  uplink/round={hist.uplink_floats:>5} floats"
              f"  {hist.wall_time_s / args.rounds * 1e3:7.2f} ms/round"
              f"  gap: {gaps}")


if __name__ == "__main__":
    main()
