"""Core library of the port: FLeNS and the round loop it runs under.

This slice ports the paper's method (``flens``, ``flens_plus``); the
other Table-I optimizers come with the next slice."""
from repro_torch.core.base import (
    FederatedOptimizer,
    History,
    build_round,
    root_key,
    run_rounds,
)
from repro_torch.core.federated import (
    FederatedProblem,
    make_problem,
    newton_solve,
)
from repro_torch.core.flens import FLeNS
from repro_torch.core.losses import OBJECTIVES, least_squares, logistic
from repro_torch.core.sketch import (
    Sketch,
    effective_dimension,
    make_sketch,
    sketch_psd,
)
from repro_torch.core.sketch_policy import SketchPolicy, as_policy

_REGISTRY = {
    "flens": FLeNS,
    "flens_plus": lambda **k: FLeNS(variant="plus", **k),
}

ALGORITHMS = tuple(_REGISTRY)


def make_optimizer(name: str, **kw) -> FederatedOptimizer:
    """Factory over the ported algorithms (``ALGORITHMS``)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"optimizer {name!r} is not ported yet; ported: {ALGORITHMS}")
    return _REGISTRY[name](**kw)
