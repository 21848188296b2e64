"""One rank of the port's multi-process CPU tests (gloo over a FileStore).

    python tests/_torch_dist_child.py JOB.json RANK

``JOB.json`` names the job (``"flens"`` or ``"moe"``), the world size,
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


def main(job_path: str, rank: int) -> int:
    from repro_torch.launch.mesh import process_group

    torch.set_num_threads(1)
    job = json.loads(pathlib.Path(job_path).read_text())
    with process_group(rank, job["world"], job["store"], backend="gloo",
                       timeout_s=job.get("timeout_s", 60)):
        out = {"flens": flens_job, "moe": moe_job}[job["kind"]](job, rank)
    np.savez(pathlib.Path(job["out"]) / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
