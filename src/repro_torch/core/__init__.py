"""Core library of the port: FLeNS, every Table-I baseline and the round
loop they run under (``repro.core``'s registry, in its order)."""
from repro_torch.core.base import (
    FederatedOptimizer,
    History,
    build_round,
    root_key,
    run_rounds,
)
from repro_torch.core.federated import (
    ClientPopulation,
    DatasetPopulation,
    FederatedProblem,
    SyntheticPopulation,
    make_problem,
    newton_solve,
)
from repro_torch.core.first_order import FedAvg, FedProx
from repro_torch.core.flens import FLeNS
from repro_torch.core.losses import OBJECTIVES, least_squares, logistic
from repro_torch.core.newton_family import (
    DistributedNewton,
    FedNew,
    FedNewton,
    FedNL,
    LocalNewton,
)
from repro_torch.core.sketch import (
    Sketch,
    effective_dimension,
    make_sketch,
    make_sketches,
    sketch_psd,
    sketch_sqrt_rows,
)
from repro_torch.core.sketch_policy import SketchPolicy, as_policy
from repro_torch.core.sketched import FedNDES, FedNS

_REGISTRY = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fednewton": FedNewton,
    "distributed_newton": DistributedNewton,
    "local_newton": LocalNewton,
    "fednew": FedNew,
    "fednl": FedNL,
    "fedns": FedNS,
    "fedndes": FedNDES,
    "flens": FLeNS,
    "flens_plus": lambda **k: FLeNS(variant="plus", **k),
}

ALGORITHMS = tuple(_REGISTRY)


def make_optimizer(name: str, **kw) -> FederatedOptimizer:
    """Factory over every implemented algorithm (Table I)."""
    return _REGISTRY[name](**kw)
