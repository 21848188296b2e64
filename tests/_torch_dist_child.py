"""One rank of the port's multi-process CPU tests (gloo over a FileStore).

    python tests/_torch_dist_child.py JOB.json RANK

``JOB.json`` names the job (``"flens"``, ``"moe"``, ``"moe_grad"``,
``"client_mesh"``, ``"lm_mesh"``, ``"lm_mesh_recurrent"``,
``"lm_mesh_rightsized"``, ``"lm_mesh_cross"`` (these two run
``lm_mesh_job``) or ``"lm_mesh_train"``), the world size,
the store file, the input ``.npz`` and the output directory; the rank
writes ``rank{RANK}.npz`` there. It imports the port only (no JAX): the
reference's draws and parameters arrive as numpy arrays. The tests
start the ranks with ``repro_torch.launch.mesh.spawn`` and join them
with a timeout.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch.core.sketch import SrhtSketch
from repro_torch.core.sketch_policy import SketchPolicy

KEY_SEP = "/"


@dataclasses.dataclass(frozen=True)
class InjectedPolicy(SketchPolicy):
    """A policy whose round ``t`` operator is given: ``signs[t]``,
    ``rows[t]`` (the reference's draws for the round seed t)."""

    signs: object = dataclasses.field(default=None, compare=False)
    rows: object = dataclasses.field(default=None, compare=False)

    @classmethod
    def of(cls, spec: str, k: int, signs, rows) -> "InjectedPolicy":
        base = SketchPolicy.parse(spec).with_k(k)
        return cls(**dataclasses.asdict(base), signs=np.asarray(signs),
                   rows=np.asarray(rows))

    def sample(self, key, round_idx, dim, dtype=torch.float32,
               device="cuda"):
        return SrhtSketch(self.k, dim,
                          torch.tensor(self.signs[round_idx], dtype=dtype,
                                       device=device),
                          torch.tensor(self.rows[round_idx],
                                       dtype=torch.int64, device=device))

    def basis_key(self, key, round_idx):
        return torch.tensor([int(round_idx)])

    def materialize(self, key, dim, dtype=torch.float32, device="cuda"):
        """Round ``key[0]``'s operator (``basis_key`` carries the round)."""
        return self.sample(None, int(key[0]), dim, dtype, device)


def unflatten(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        *head, last = path.split(KEY_SEP)
        for name in head:
            node = node.setdefault(name, {})
        node[last] = value
    return out


def flens_job(job: dict, rank: int) -> dict:
    """The 4-rank DistributedFLeNS runs: a (4,) "data" mesh on the m = 4
    problem's rows, a (2 data, 2 model) mesh with client axes ("pod",
    "data") on the m = 2 problem's, and rows that do not divide."""
    from repro_torch.core import logistic
    from repro_torch.core.distributed import DistributedFLeNS, run_distributed
    from repro_torch.launch.mesh import make_mesh

    d = np.load(job["data"])
    k, dim, rounds = int(d["k"]), int(d["dim"]), int(d["rounds"])
    policy = InjectedPolicy.of("srht", k, d["signs"], d["rows"])
    w0 = torch.zeros(dim, dtype=torch.float64)
    out = {}
    for name, shape, axes, client_axes in (
            ("m4", (4,), ("data",), ("data",)),
            ("m2", (2, 2), ("data", "model"), ("pod", "data"))):
        mesh = make_mesh(shape, axes, "cpu")
        flens = DistributedFLeNS(mesh=mesh, objective=logistic, dim=dim, k=k,
                                 lam=1e-3, beta=0.0, client_axes=client_axes,
                                 sketch=policy)
        X, y = torch.from_numpy(d[f"X_{name}"]), torch.from_numpy(d[f"y_{name}"])
        _, ws = run_distributed(flens, X, y, w0, rounds)
        out[f"w_{name}"] = torch.stack(ws).numpy()
        if name == "m4":
            try:
                flens.shard_data(X[:-2], y[:-2])
                out["indivisible"] = np.array("")
            except ValueError as err:
                out["indivisible"] = np.array(str(err))
    return out


def moe_job(job: dict, rank: int) -> dict:
    """moe_apply on every case of the job: this rank's shard of the
    experts and of the batch, under the case's mesh."""
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    d = np.load(job["data"])
    meshes = {}
    out = {}
    for case in job["cases"]:
        name, arch = case["name"], case["arch"]
        cfg = get_config(arch).reduced()
        key = (tuple(case["shape"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = make_mesh(*key, "cpu")
        mesh = meshes[key]
        params = lm_params_from_numpy(unflatten(
            {p[len(arch) + 1:]: d[p] for p in d.files
             if p.startswith(arch + KEY_SEP)}), cfg, device="cpu")
        x = torch.from_numpy(d[f"x/{name}"])
        b, t, _ = x.shape
        with use_mesh(mesh), moe.record_routes() as routes:
            branch = moe.moe_branch(mesh, b, t)
            local = moe.moe_local_params(mesh, params, branch)
            xl = rules.local_shard(mesh, x, rules.batch_spec(mesh, (), x))
            o, aux, drop = moe.moe_apply(local, xl, cfg)
        out[f"{name}/out"] = o.numpy()
        out[f"{name}/aux"] = aux.numpy()
        out[f"{name}/drop"] = drop.numpy()
        out[f"{name}/ids"] = routes[0]["ids"].numpy()
        out[f"{name}/keep"] = routes[0]["keep"].numpy()
        out[f"{name}/branch"] = np.array(branch)
        out[f"{name}/coord"] = np.array(
            [rules.coordinate(mesh)[a] for a in case["axes"]])
    return out


def flatten(tree, prefix: str = "") -> dict:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` (numpy leaves)."""
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(flatten(sub, f"{prefix}{name}{KEY_SEP}"))
        return out
    return {prefix[:-1]: tree.detach().numpy()}


def moe_grad_job(job: dict, rank: int) -> dict:
    """The backward of moe_apply on every case of the job: this rank's
    gradients of x (its batch rows), the router, its expert shard and
    the shared expert, of sum(out * g) + aux_coef aux; and the P1 case:
    a ("model",) mesh of ranks 0 and 1 beside the no-mesh backward."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh

    d = np.load(job["data"])
    coef = float(job["aux_coef"])

    def grads(params, x, g, mesh):
        params = _leaves_requiring_grad(params)
        x = x.clone().requires_grad_()
        with use_mesh(mesh):
            o, aux, _ = moe.moe_apply(params, x, cfg)
        (torch.sum(o * g) + coef * aux).backward()
        out = flatten(_grads_of(params))
        out["x"] = x.grad.numpy()
        return out

    meshes = {}
    out = {}
    for case in job["cases"]:
        name, arch = case["name"], case["arch"]
        cfg = get_config(arch).reduced()
        key = (tuple(case["shape"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = make_mesh(*key, "cpu")
        mesh = meshes[key]
        params = lm_params_from_numpy(unflatten(
            {p[len(arch) + 1:]: d[p] for p in d.files
             if p.startswith(arch + KEY_SEP)}), cfg, device="cpu")
        x = torch.from_numpy(d[f"x/{name}"])
        g = torch.from_numpy(d[f"g/{name}"])
        spec = rules.batch_spec(mesh, (), x)
        branch = moe.moe_branch(mesh, *x.shape[:2])
        local = moe.moe_local_params(mesh, params, branch)
        got = grads(local, rules.local_shard(mesh, x, spec),
                    rules.local_shard(mesh, g, spec), mesh)
        out.update({f"{name}/{k}": v for k, v in got.items()})
    # P1: two ranks of a ("model",) mesh (ranks 2 and 3 take no part)
    arch = job["p1"]["arch"]
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(unflatten(
        {p[len(arch) + 1:]: d[p] for p in d.files
         if p.startswith(arch + KEY_SEP)}), cfg, device="cpu")
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("model",))
    if rank < 2:
        x, g = torch.from_numpy(d["x/p1"]), torch.from_numpy(d["g/p1"])
        local = moe.moe_local_params(mesh, params, "expert")
        out["p1/mesh/x"] = grads(local, x, g, mesh)["x"]
        out["p1/none/x"] = grads(params, x, g, None)["x"]
    torch.distributed.barrier()
    return out


def _leaves_requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaves_requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def _grads_of(tree):
    if isinstance(tree, dict):
        return {k: _grads_of(v) for k, v in tree.items()}
    return tree.grad


# -- cohorts split over ranks (run_rounds(..., client_mesh=)) ----------------

# m 40 clients of 20 rows, 8 features; cohorts of 8 (uniform:0.2), 20
# (uniform:0.5) and 6 (uniform:0.15, which does not divide 4 ranks)
CM_M, CM_ROWS, CM_DIM, CM_ROUNDS = 40, 800, 8, 3
EDGE = dict(uplink_bytes_per_s="loguniform:3e4,3e6",
            downlink_bytes_per_s="loguniform:3e5,3e7", latency_s=0.08,
            straggler_prob=0.20, straggler_slowdown=10.0, dropout_prob=0.10)
EDGE_CODECS = {"h_sk": "sympack+qint8", "sg": "qint8",
               "grad": "topk0.1+qint8", "default": "qint8"}
# every Table-I optimizer a population admits (all but FedNew), and
# FLeNS without its guard (the server's loss read outside the uplink)
CM_OPTIMIZERS = {
    "flens": ("flens", dict(k=4)),
    "flens_plus": ("flens_plus", dict(k=4)),
    "flens_noguard": ("flens", dict(k=4, restart=False)),
    "fedavg": ("fedavg", {}),
    "fedprox": ("fedprox", {}),
    "fednewton": ("fednewton", {}),
    "distributed_newton": ("distributed_newton", {}),
    "local_newton": ("local_newton", {}),
    "fednl": ("fednl", {}),
    "fedns": ("fedns", dict(k=4)),
    "fedndes": ("fedndes", dict(k_min=4)),
}


def client_mesh_config(name: str):
    """The transports of the client-mesh runs, by name."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.dynamics import DynamicsConfig

    if name == "identity":
        return CommConfig(scheduler="uniform:0.2", seed=1)
    if name == "edge_ef":
        return CommConfig(scheduler="uniform:0.2", seed=1, codecs=EDGE_CODECS,
                          error_feedback=True, channel=ChannelModel(**EDGE))
    if name == "robust":
        return CommConfig(scheduler="uniform:0.2", seed=1,
                          channel=ChannelModel(dropout_prob=0.25),
                          dynamics=DynamicsConfig(threat="noise:0.2,1.0",
                                                  robust="median", seed=3))
    if name == "churn":
        return CommConfig(scheduler="uniform:0.5", seed=1,
                          dynamics=DynamicsConfig(churn="step:t=1,frac=0.6",
                                                  seed=2))
    if name == "replicated":
        return CommConfig(scheduler="uniform:0.15", seed=1)
    if name == "async":
        return CommConfig(scheduler="uniform:0.2", seed=1, async_mode=True,
                          buffer_size=4, staleness="inverse",
                          channel=ChannelModel(straggler_prob=0.3,
                                               straggler_slowdown=10.0))
    raise ValueError(name)


def client_mesh_runs() -> "list[dict]":
    """Every (transport, optimizer) run of the client-mesh test."""
    runs = [{"config": c, "opt": o}
            for c in ("identity", "edge_ef", "robust", "churn")
            for o in CM_OPTIMIZERS]
    runs += [{"config": "replicated", "opt": o}
             for o in ("flens_plus", "fedavg", "fedns")]
    runs += [{"config": "async", "opt": o}
             for o in ("flens_plus", "fedavg", "fedns")]
    for r in runs:
        r["name"] = f"{r['config']}-{r['opt']}"
    return runs


def client_mesh_data():
    """The runs' rows: (800, 8) features and +-1 labels, from a seed."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((CM_ROWS, CM_DIM))
    w = rng.standard_normal(CM_DIM)
    y = np.where(X @ w + 0.5 * rng.standard_normal(CM_ROWS) > 0, 1.0, -1.0)
    return X, y


def population_run(run: dict, mesh) -> dict:
    """One run on the CPU: the population of ``client_mesh_data``, the
    run's optimizer and transport, ``client_mesh=mesh``. Returns the
    iterate of every round the optimizer ran (an async commit's group
    rounds too), the losses and the bytes."""
    from repro_torch.core import (
        DatasetPopulation,
        logistic,
        make_optimizer,
        newton_solve,
        run_rounds,
    )

    X, y = client_mesh_data()
    pop = DatasetPopulation(X, y, CM_M, 1e-3, logistic, seed=0, device="cpu")
    w0 = torch.zeros(CM_DIM, dtype=torch.float64)
    w_star = newton_solve(pop.eval_problem(), w0)
    name, kw = CM_OPTIMIZERS[run["opt"]]
    opt = make_optimizer(name, **kw)
    ws = []
    inner = opt.round

    def round_(problem, state, key, comm=None):
        out = inner(problem, state, key, comm=comm)
        ws.append(out["w"])
        return out

    opt.round = round_
    h = run_rounds(opt, pop, w0, w_star, CM_ROUNDS, seed=0,
                   comm=client_mesh_config(run["config"]), client_mesh=mesh)
    return {"w": torch.stack(ws).numpy(), "loss": h.loss,
            "bytes": h.cumulative_bytes}


def reference_run(d, mesh) -> dict:
    """FLeNS (k 4) on the reference's population rows with its cohorts
    and operators injected (``ids`` (R, c), ``signs``, ``rows``), the
    identity transport, ``client_mesh=mesh``: losses and bytes."""
    from repro_torch import interop
    from repro_torch.comm import scheduler
    from repro_torch.core import FLeNS, run_rounds

    pop = interop.dataset_population_from_numpy(
        d["rows_X"], d["rows_y"], d["sizes"], int(d["n_shard"]), 1e-3,
        "logistic", device="cpu")
    ids = d["ids"]

    def sample_ids(self, key, round_idx, m, channel, eligible=None):
        return np.asarray(ids[round_idx], dtype=np.int64)

    inner = scheduler.UniformSampler.sample_ids
    scheduler.UniformSampler.sample_ids = sample_ids
    try:
        opt = FLeNS(k=4, sketch=InjectedPolicy.of("srht", 4, d["signs"],
                                                   d["rows"]))
        h = run_rounds(opt, pop, torch.zeros(CM_DIM, dtype=torch.float64),
                       torch.from_numpy(d["w_star"]), len(ids), seed=0,
                       comm=client_mesh_config("identity"), client_mesh=mesh)
    finally:
        scheduler.UniformSampler.sample_ids = inner
    return {"loss": h.loss, "bytes": h.cumulative_bytes,
            "ids": np.stack([tr.ids for tr in h.traces])}


def client_mesh_job(job: dict, rank: int) -> dict:
    """Every client-mesh run on a (4,) "data" mesh, and the run against
    the reference's with its draws injected."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), "cpu")
    out = {}
    for run in client_mesh_runs():
        for k, v in population_run(run, mesh).items():
            out[f"{run['name']}/{k}"] = v
    for k, v in reference_run(np.load(job["data"]), mesh).items():
        out[f"reference/{k}"] = v
    return out


# -- LMs served over a mesh ---------------------------------------------------

def model_config(job: dict, name: str):
    """The reduced config a model name of the job stands for: the arch
    ``job["configs"][name]`` (``name`` itself by default) with the
    overrides ``job["overrides"][name]``."""
    from repro_torch.configs import get_config

    arch = job.get("configs", {}).get(name, name)
    return get_config(arch).reduced(**job.get("overrides", {}).get(name, {}))


MEMORY_KEYS = ("vision", "audio_frames")  # a batch's memory inputs


def lm_mesh_run(model, params, tokens, steps, cache_len: int,
                memory: "dict | None" = None):
    """A prefill of ``tokens`` (and the batch's ``memory`` inputs) then a
    decode step of each of ``steps`` (teacher-forced, (n, B, 1)): (the
    logits of every call (n + 1, B, V), the final state)."""
    with torch.no_grad():
        logits, state = model.prefill(params, {"inputs": tokens,
                                               **(memory or {})},
                                      cache_len=cache_len)
        out = [logits]
        for step in steps:
            logits, state = model.decode_step(params, state, step)
            out.append(logits)
    return torch.stack(out), state


def lm_mesh_engine(model, params, prompts, new_tokens: int, max_batch: int,
                   cache_len: int) -> list:
    """Every request's generated tokens through ``ServingEngine``."""
    from repro_torch.serving import Request, ServingEngine

    engine = ServingEngine(model, params, max_batch=max_batch,
                           cache_len=cache_len)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        engine.run()
    return [r.generated for r in reqs]


def lm_mesh_job(job: dict, rank: int) -> dict:
    """Each case of the job under its mesh: this rank's serving shard of
    the arch's parameters (``interop.lm_shard_from_numpy``), a prefill
    (with the case's memory inputs, the global batch's ``vision`` or
    ``audio_frames``, where the data has them) and teacher-forced decode
    steps of the global batch (logits, the
    final state's shards, the parameter and state shapes), the engine
    cases' token streams, and (where the job names a ``grad_case``) the
    gradients of a prefill's logits through the mesh's collectives. A case's ``arch`` names its model (``model_config``)."""
    from repro_torch.interop import lm_shard_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.sharding.ctx import use_mesh

    d = np.load(job["data"])
    meshes, shards, out = {}, {}, {}

    def setup(arch, mesh_name):
        shape, axes = job["meshes"][mesh_name]
        if mesh_name not in meshes:
            meshes[mesh_name] = make_mesh(tuple(shape), tuple(axes), "cpu")
        mesh = meshes[mesh_name]
        cfg = model_config(job, arch)
        key = (arch, mesh_name)
        if key not in shards:
            shards[key] = lm_shard_from_numpy(unflatten(
                {p[len(arch) + 1:]: d[p] for p in d.files
                 if p.startswith(arch + KEY_SEP)}), cfg, mesh, device="cpu")
        return mesh, cfg, LM(cfg), shards[key]

    for case in job["cases"]:
        name = case["name"]
        mesh, cfg, model, params = setup(case["arch"], case["mesh"])
        memory = {key: torch.from_numpy(d[f"{key}/{name}"])
                  for key in MEMORY_KEYS if f"{key}/{name}" in d.files}
        with use_mesh(mesh):
            logits, state = lm_mesh_run(
                model, params, torch.from_numpy(d[f"tokens/{name}"]),
                torch.from_numpy(d[f"steps/{name}"]), case["cache_len"],
                memory)
        out[f"{name}/logits"] = logits.numpy()
        out.update({f"{name}/state/{k}": v for k, v in
                    flatten({str(gi): g for gi, g in
                             enumerate(state["groups"])}).items()})
        out.update({f"{name}/params/{k}": np.array(v.shape) for k, v in
                    flatten(params).items()})
    for case in job["engine"]:
        mesh, cfg, model, params = setup(case["arch"], case["mesh"])
        with use_mesh(mesh):
            streams = lm_mesh_engine(model, params, job["prompts"],
                                     job["new_tokens"], job["max_batch"],
                                     job["cache_len"])
        out[f"engine/{case['name']}"] = np.array(streams)
    if "grad_case" not in job:
        return out
    # a backward through the serving run's collectives: the gradient of
    # sum(logits * g) (the prefill's global logits, g from the data) with
    # respect to the rank's serving shard
    mesh, cfg, model, params = setup(*job["grad_case"])
    leaves = _leaves_requiring_grad(params)
    with use_mesh(mesh):
        logits, _ = model.prefill(leaves, {"inputs": torch.from_numpy(
            d["grad/tokens"])})
        torch.sum(logits * torch.from_numpy(d["grad/g"])).backward()
    out.update({f"grad/{k}": v for k, v in
                flatten(_grads_of(leaves)).items()})
    return out


def lm_mesh_recurrent_job(job: dict, rank: int) -> dict:
    """``lm_mesh_job`` on the recurrent kinds, then each case named in
    ``job["window_off"]`` again with griffin's window lifted from its
    decode steps alone (the prefill as before): their logits, which the
    window's mask over the cache's sequence shards must change."""
    import dataclasses

    from repro_torch.interop import lm_shard_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.sharding.ctx import use_mesh

    out = lm_mesh_job(job, rank)
    d = np.load(job["data"])
    cases = {c["name"]: c for c in job["cases"]}
    for name in job.get("window_off", ()):
        case = cases[name]
        arch = case["arch"]
        cfg = model_config(job, arch)
        mesh = make_mesh(*map(tuple, job["meshes"][case["mesh"]]), "cpu")
        params = lm_shard_from_numpy(unflatten(
            {p[len(arch) + 1:]: d[p] for p in d.files
             if p.startswith(arch + KEY_SEP)}), cfg, mesh, device="cpu")
        unbounded = LM(dataclasses.replace(cfg, window=1 << 20))
        with use_mesh(mesh), torch.no_grad():
            _, state = LM(cfg).prefill(
                params, {"inputs": torch.from_numpy(d[f"tokens/{name}"])},
                cache_len=case["cache_len"])
            got = []
            for step in torch.from_numpy(d[f"steps/{name}"]):
                logits, state = unbounded.decode_step(params, state, step)
                got.append(logits)
        out[f"{name}/window_off"] = torch.stack(got).numpy()
    return out


def lm_mesh_train_job(job: dict, rank: int) -> dict:
    """Each case of the job under its mesh: this rank's training shard of
    the model's parameters (``interop.lm_train_shard_from_numpy``), the
    loss, ce, aux and gradient blocks of the global batch (with its
    memory inputs where the data has them; ``loss_and_grads``), then one
    ``train_step`` from the case's AdamW state
    (``interop.adamw_shard_from_numpy``): its loss, ce and gnorm and the
    blocks of the new parameters and moments. Then each CE case:
    ``mesh_cross_entropy`` of the rank's rows and vocab block, and its
    gradients of the rank's features and table block."""
    from repro_torch.interop import (adamw_shard_from_numpy,
                                     lm_train_shard_from_numpy)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import loss_and_grads, train_step
    from repro_torch.models.common import mesh_cross_entropy
    from repro_torch.models.lm import LM
    from repro_torch.sharding import rules
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.ctx import use_mesh

    d = np.load(job["data"])
    meshes, out = {}, {}

    def mesh_of(name):
        if name not in meshes:
            shape, axes = job["meshes"][name]
            meshes[name] = make_mesh(tuple(shape), tuple(axes), "cpu")
        return meshes[name]

    def tree_of(prefix):
        return unflatten({p[len(prefix):]: d[p] for p in d.files
                          if p.startswith(prefix)})

    for case in job["cases"]:
        name, model_name = case["name"], case["model"]
        mesh = mesh_of(case["mesh"])
        cfg = model_config(job, model_name)
        model = LM(cfg)
        params = lm_train_shard_from_numpy(tree_of(model_name + KEY_SEP), cfg,
                                           mesh, device="cpu")
        batch = {key: torch.from_numpy(d[f"{key}/{name}"])
                 for key in ("inputs", "labels", "mask", *MEMORY_KEYS)
                 if f"{key}/{name}" in d.files}
        state = adamw_shard_from_numpy(
            {"m": tree_of(f"m/{model_name}/"), "v": tree_of(f"v/{model_name}/"),
             "step": np.array(job["adam_step"])}, mesh, device="cpu")
        with use_mesh(mesh):
            loss, metrics, grads = loss_and_grads(model, params, batch)
            p2, s2, loss2, ce2, gnorm = train_step(model, params, state, batch,
                                                   job["lr"])
        out[f"{name}/loss"] = loss.numpy()
        out[f"{name}/ce"] = metrics["ce"].numpy()
        out[f"{name}/aux"] = metrics["aux"].numpy()
        out[f"{name}/step_loss"] = loss2.numpy()
        out[f"{name}/step_ce"] = ce2.numpy()
        out[f"{name}/gnorm"] = gnorm.numpy()
        for key, tree in (("grads", grads), ("params", p2), ("m", s2["m"]),
                          ("v", s2["v"])):
            out.update({f"{name}/{key}/{k}": v
                        for k, v in flatten(tree).items()})
    for case in job.get("ce_cases", ()):
        name = case["name"]
        mesh = mesh_of(case["mesh"])
        lay = tp.layout(mesh)
        feats = torch.from_numpy(d[f"feats/{name}"])
        table = torch.from_numpy(d[f"table/{name}"])
        labels = torch.from_numpy(d[f"labels/{name}"])
        mask = torch.from_numpy(d[f"mask/{name}"])
        spec = rules.batch_spec(mesh, (), feats)
        rows = lambda a: rules.local_shard(mesh, a, spec)  # noqa: E731
        vocab = table.shape[0]
        tspec = rules.param_spec(mesh, ("embed", "table"), table)[:1]
        f = rows(feats).clone().requires_grad_()
        t = rules.local_shard(mesh, table, tspec).clone().requires_grad_()
        row_group = lay.block(spec, 0, len(feats))[2]
        with use_mesh(mesh):
            # each data rank reads the table on its own rows, as the
            # LM's weights do (_OnMesh.weights)
            ce = mesh_cross_entropy(
                f, tp.replicated_input(t, row_group), rows(labels),
                rows(mask), vocab=vocab, chunk=case["chunk"],
                model=lay.model, model_index=lay.model_index, rows=row_group)
            ce.backward()
        out[f"ce/{name}/ce"] = ce.detach().numpy()
        out[f"ce/{name}/feats"] = f.grad.numpy()
        out[f"ce/{name}/table"] = t.grad.numpy()
    return out


def main(job_path: str, rank: int) -> int:
    from repro_torch.launch.mesh import process_group

    torch.set_num_threads(1)
    job = json.loads(pathlib.Path(job_path).read_text())
    with process_group(rank, job["world"], job["store"], backend="gloo",
                       timeout_s=job.get("timeout_s", 60)):
        out = {"flens": flens_job, "moe": moe_job, "moe_grad": moe_grad_job,
               "client_mesh": client_mesh_job,
               "lm_mesh": lm_mesh_job,
               "lm_mesh_recurrent": lm_mesh_recurrent_job,
               "lm_mesh_rightsized": lm_mesh_job,
               "lm_mesh_cross": lm_mesh_job,
               "lm_mesh_train": lm_mesh_train_job}[job["kind"]](
                   job, rank)
    np.savez(pathlib.Path(job["out"]) / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
