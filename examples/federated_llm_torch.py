"""FLeNS-head on the PyTorch/CUDA port: the paper's optimizer inside an LLM
fine-tuning loop (the counterpart of examples/federated_llm.py).

m federated clients share a reduced TinyLlama backbone and fine-tune a
binary classification head on their private token data. The head
objective given backbone features is the paper's convex problem, so
FLeNS applies as it is:

  1. warm up the backbone with a few AdamW LM steps (shared, public data);
  2. every client extracts features from its private sequences;
  3. run FLeNS rounds on the federated head objective (a sketched k x k
     Hessian uplink per client) beside FedAvg and FedNewton.

  PYTHONPATH=src python examples/federated_llm_torch.py                # on the card
  PYTHONPATH=src python examples/federated_llm_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import make_optimizer, newton_solve, run_rounds
from repro_torch.core.base import root_key
from repro_torch.data.lm_stream import FastLMStream
from repro_torch.launch.train import train_step
from repro_torch.models.lm import LM
from repro_torch.optim import adamw_init, extract_features, head_problem


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    m_clients, n_per_client, seq = 8, 64, 32
    cfg = get_config("tinyllama-1.1b").reduced(d_model=128, vocab=256)
    model = LM(cfg)
    params = model.init(root_key(0, device=dev))

    # 1. brief LM warmup so the features aren't random projections
    stream = FastLMStream(cfg.vocab, seq, batch=8, seed=0, device=dev)
    opt_state = adamw_init(params)
    for batch in stream.batches(30):
        params, opt_state, loss, _, _ = train_step(model, params, opt_state,
                                                   batch, lr=1e-3)
    print(f"backbone warmup done (lm loss {float(loss):.3f})")

    # 2. private client data: label = does the sequence contain a marker
    #    token pattern (a nonlinear function of the tokens, so the backbone
    #    features are useful)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(m_clients * n_per_client, seq))
    labels = np.where((toks < 8).sum(axis=1) >= 2, 1.0, -1.0)
    feats = extract_features(model, params,
                             torch.tensor(toks, dtype=torch.int32, device=dev))
    print(f"features: {tuple(feats.shape)}, positives: "
          f"{(labels > 0).mean():.2f}")

    # 3. federated second-order head training with FLeNS
    prob = head_problem(feats, torch.tensor(labels, device=dev), m_clients,
                        lam=1e-3)
    w0 = torch.zeros(prob.dim, dtype=torch.float64, device=dev)
    w_star = newton_solve(prob, w0, iters=40)

    k = min(64, prob.dim)
    for name, kw in [("fedavg", dict(lr=1.0, local_steps=5)),
                     ("flens", dict(k=k)), ("fednewton", {})]:
        hist = run_rounds(make_optimizer(name, **kw), prob, w0, w_star,
                          rounds=10)
        print(f"{hist.name:>10} uplink/round={hist.uplink_floats:>6} "
              f"gap: " + "  ".join(f"{g:.1e}" for g in hist.gap[::2]))

    acc = float(torch.mean(((feats.double() @ w_star > 0)
                            == torch.tensor(labels > 0, device=dev)).double()))
    print(f"head accuracy at w*: {acc:.3f} (chance 0.5)")


if __name__ == "__main__":
    main()
