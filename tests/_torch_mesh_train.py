"""The machinery of the port's mesh-training parity files
(``test_torch_lm_mesh_train*.py``).

A ``Suite`` names a file's models (an arch and its ``reduced()``
overrides), its cases (a model, a mesh, the batch's B and T, and whether
a mask's counts differ between the data ranks) and how the reference's
parameters are perturbed from their init (its zero norm scales, and
where a file asks, every zero leaf and the vlm's gates). ``run`` draws
the reference's parameters with JAX, AdamW moments of step ``ADAM_STEP``
from a seed and every case's batch (with the vlm's vision tokens or
whisper's frames), then starts the reference's JAX subprocesses
(``REFERENCE``: ``--xla_force_host_platform_device_count=4``, its mesh's
axes Auto, ``jax.jit(jax.value_and_grad(model.loss, has_aux=True))`` on
parameters placed by ``rules.param_spec`` and the batch by
``rules.batch_spec``, then ``adamw_update``) beside the port's 4 gloo
ranks (``_torch_dist_child.py``, job ``lm_mesh_train``), joined with a
timeout. The ``check_*`` functions hold a case's ranks to the
reference's run: loss, ce and aux equal on every rank and within
``LOSS_RTOL`` (relative); each gradient block within ``GRAD_TOL`` of the
reference leaf's largest |gradient|, bit-equal across the ranks that
hold the same block; after one ``train_step``, gnorm equal on every rank
and within ``LOSS_RTOL``, and the blocks of the parameters and both
moments within ``GRAD_TOL`` of each leaf's largest |value|.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.sharding import rules

from _torch_dist_child import KEY_SEP

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(__file__).resolve().parent / "_torch_dist_child.py"
MESHES = {"dm": ((2, 2), ("data", "model")), "m4": ((4,), ("model",))}
LR, ADAM_STEP = 1e-3, 3
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
TIMEOUT_S = 240
GATES = (0.7, -0.5)  # the vlm's gate and gate_mlp, where a suite sets them

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.models.lm import LM
    from repro.optim import adamw_update
    from repro.sharding import rules
    from repro.sharding.ctx import use_mesh

    job = json.load(open(sys.argv[1]))
    d = np.load(job["data"])
    meshes = {name: jax.make_mesh(tuple(shape), tuple(axes),
                                  axis_types=(jax.sharding.AxisType.Auto,)
                                  * len(axes))
              for name, (shape, axes) in job["meshes"].items()}

    def tree_of(prefix):
        out = {}
        for p in d.files:
            if p.startswith(prefix):
                node = out
                *head, last = p[len(prefix):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = jnp.asarray(d[p])
        return out

    def place(tree, mesh, rule):
        return jax.device_put(tree, rules.tree_shardings(mesh, tree, rule))

    def leaves_of(tree, prefix):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                yield from leaves_of(sub, f"{prefix}/{key}")
        else:
            yield prefix, np.asarray(tree)

    out = {}
    part = int(sys.argv[2])
    for case in job["cases"][part::job["reference_parts"]]:
        name, model_name = case["name"], case["model"]
        mesh = meshes[case["mesh"]]
        model = LM(get_config(job["configs"].get(model_name, model_name))
                   .reduced(**job["overrides"].get(model_name, {})))
        batch = {key: jnp.asarray(d[f"{key}/{name}"])
                 for key in ("inputs", "labels", "mask", "vision",
                             "audio_frames")
                 if f"{key}/{name}" in d.files}

        def step(p, s, b):
            (loss, met), g = jax.value_and_grad(model.loss, has_aux=True)(p, b)
            p2, s2, gnorm = adamw_update(p, g, s, lr=job["lr"])
            return loss, met, g, p2, s2, gnorm

        with use_mesh(mesh):
            params = place(tree_of(model_name + "/"), mesh, rules.param_spec)
            state = {"m": place(tree_of(f"m/{model_name}/"), mesh,
                                rules.param_spec),
                     "v": place(tree_of(f"v/{model_name}/"), mesh,
                                rules.param_spec),
                     "step": jnp.asarray(job["adam_step"], jnp.int32)}
            batch = place(batch, mesh, rules.batch_spec)
            loss, met, g, p2, s2, gnorm = jax.jit(step)(params, state, batch)
        out[name + "/loss"] = np.asarray(loss)
        out[name + "/ce"] = np.asarray(met["ce"])
        out[name + "/aux"] = np.asarray(met["aux"])
        out[name + "/gnorm"] = np.asarray(gnorm)
        for key, tree in (("grads", g), ("params", p2), ("m", s2["m"]),
                          ("v", s2["v"])):
            out.update(leaves_of(tree, f"{name}/{key}"))
    np.savez(job["out"] + f"/reference{part}.npz", **out)
""")


@dataclasses.dataclass(frozen=True, eq=False)
class Suite:
    """A file's models {name: (arch, reduced() overrides)}, cases {name:
    (model, mesh of ``MESHES``, B, T, masked)}, its reference's JAX
    subprocesses (case i in part i % ``reference_parts``) and whether
    every zero leaf of the reference's init is noised and the vlm's gates
    set (``noise_zeros``; else only the norm scales are noised)."""

    models: dict
    cases: dict
    reference_parts: int = 2
    noise_zeros: bool = False

    def cfg(self, model: str):
        arch, overrides = self.models[model]
        return get_config(arch).reduced(**overrides)

    def mesh(self, case: str) -> MeshShape:
        shape, axes = MESHES[self.cases[case][1]]
        return MeshShape(axes, shape)


def flatten(tree, prefix=""):
    """``{"a": {"b": x}}`` -> ``{"a/b": numpy x}``."""
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            out.update(flatten(sub, f"{prefix}{name}{KEY_SEP}"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, a in flat.items():
        node = out
        *head, last = path.split(KEY_SEP)
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a
    return out


@functools.cache
def params(suite: Suite, model: str) -> dict:
    """The reference's parameters (numpy, flat) of a model's reduced
    config: its norm scales (zero at init) set to seeded noise, or with
    ``suite.noise_zeros`` every zero leaf, and the vlm's gates set to
    ``GATES`` (the reference starts them at 0, where the memory reaches
    no logit)."""
    arch, overrides = suite.models[model]
    jcfg = jget_config(arch).reduced(**overrides)
    flat = flatten(jax.tree.map(np.asarray,
                                JLM(jcfg).init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(list(suite.models).index(model))
    for path, a in flat.items():
        if (path.endswith(KEY_SEP + "scale")
                or (suite.noise_zeros and not a.any())):
            flat[path] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    if suite.noise_zeros and jcfg.family == "vlm":
        for path in flat:
            name = path.split(KEY_SEP)[-1]
            if name in ("gate", "gate_mlp"):
                flat[path] = np.full_like(flat[path],
                                          GATES[name == "gate_mlp"])
    return flat


@functools.cache
def moments(suite: Suite, model: str):
    """An AdamW state's moments of step ``ADAM_STEP`` (numpy, flat), from
    a seed: m ~ 1e-3 N(0, 1), v ~ 1e-6 U(0.5, 2)."""
    rng = np.random.default_rng(10 + list(suite.models).index(model))
    m = {p: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32)
         for p, a in params(suite, model).items()}
    v = {p: (1e-6 * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
         for p, a in params(suite, model).items()}
    return m, v


def batch(suite: Suite, case: str) -> dict:
    """A case's batch (numpy): inputs and labels (B, T), the mask where
    the case has one (the first data rank's rows keep every position,
    the second's a quarter of them), the vlm's vision tokens (B,
    vision_tokens, vision_dim) or whisper's frames (B, audio_frames,
    d_model)."""
    model, _, b, t, masked = suite.cases[case]
    cfg = suite.cfg(model)
    rng = np.random.default_rng(list(suite.cases).index(case))
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        mask = np.ones((b, t), np.float32)
        mask[b // 2:] = (rng.uniform(size=(b - b // 2, t)) < 0.25)
        out["mask"] = mask
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = rng.standard_normal(
            (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return out


def run(suite: Suite, d: pathlib.Path, extra: "dict | None" = None,
        job_extra: "dict | None" = None):
    """(reference outputs, [each rank's outputs]): the reference's
    subprocesses and the port's 4 ranks, run side by side in ``d``;
    ``extra`` arrays and ``job_extra`` keys join the data and the job."""
    arrays = dict(extra or {})
    for model in suite.models:
        arrays.update({f"{model}{KEY_SEP}{p}": a
                       for p, a in params(suite, model).items()})
        m, v = moments(suite, model)
        arrays.update({f"m/{model}/{p}": a for p, a in m.items()})
        arrays.update({f"v/{model}/{p}": a for p, a in v.items()})
    for case in suite.cases:
        arrays.update({f"{key}/{case}": a
                       for key, a in batch(suite, case).items()})
    np.savez(d / "data.npz", **arrays)
    job = {"kind": "lm_mesh_train", "world": 4, "store": str(d / "store"),
           "data": str(d / "data.npz"), "out": str(d), "meshes": MESHES,
           "configs": {m: arch for m, (arch, _) in suite.models.items()},
           "overrides": {m: ov for m, (_, ov) in suite.models.items()},
           "lr": LR, "adam_step": ADAM_STEP,
           "reference_parts": suite.reference_parts,
           "cases": [{"name": n, "model": c[0], "mesh": c[1]}
                     for n, c in suite.cases.items()],
           "timeout_s": TIMEOUT_S, **(job_extra or {})}
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE,
                              str(d / "job.json"), str(part)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for part in range(suite.reference_parts)]
    try:
        spawn(lambda r: [sys.executable, str(CHILD), str(d / "job.json"),
                         str(r)], 4, timeout_s=TIMEOUT_S, env=env)
        logs = [ref.communicate(timeout=TIMEOUT_S)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log[-3000:]
    want = {}
    for part in range(suite.reference_parts):
        want.update(np.load(d / f"reference{part}.npz"))
    return want, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def _blocks(suite: Suite, case: str, key: str, want: dict, r: int):
    """(path, the rank's block of the reference's leaf, the leaf's
    largest |value|) of every leaf of ``key`` (grads, params, m, v)."""
    mesh = suite.mesh(case)
    for path in params(suite, suite.cases[case][0]):
        ref = torch.from_numpy(want[f"{case}/{key}/{path}"])
        spec = rules.param_spec(mesh, path.split(KEY_SEP), ref)
        yield (path, rules.local_shard(mesh, ref, spec, rank=r).numpy(),
               float(ref.abs().max()))


def check_loss(runs, case: str) -> None:
    want, got = runs
    for key in ("loss", "ce", "aux", "step_loss", "step_ce"):
        ref = want[f"{case}/{key.removeprefix('step_')}"]
        vals = [got[r][f"{case}/{key}"] for r in range(4)]
        assert all(np.array_equal(v, vals[0]) for v in vals), (key, vals)
        np.testing.assert_allclose(vals[0], ref, rtol=LOSS_RTOL, atol=1e-12,
                                   err_msg=key)


def check_gradient_blocks(suite: Suite, runs, case: str) -> None:
    want, got = runs
    for r in range(4):
        for path, mine, top in _blocks(suite, case, "grads", want, r):
            g = got[r][f"{case}/grads/{path}"]
            assert g.shape == mine.shape, (r, path)
            err = float(np.abs(g - mine).max()) / max(top, 1e-30)
            assert err <= GRAD_TOL, (r, path, err)


def check_bit_equal_blocks(suite: Suite, runs, case: str) -> None:
    """Ranks whose coordinates differ only on axes a leaf's spec does not
    name hold the same block, and its gradient bit for bit."""
    want, got = runs
    mesh = suite.mesh(case)
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    pairs = 0
    for path in params(suite, suite.cases[case][0]):
        spec = rules.param_spec(mesh, path.split(KEY_SEP),
                                torch.from_numpy(want[f"{case}/grads/{path}"]))
        named = {a for ax in spec if ax for a in
                 ((ax,) if isinstance(ax, str) else ax)}
        key = lambda r: tuple(c for a, c in rules.coordinate(  # noqa: E731
            mesh, r).items() if a in named)
        for r in range(1, 4):
            for q in range(r):
                if key(q) == key(r) and set(sizes) - named:
                    pairs += 1
                    assert np.array_equal(got[r][f"{case}/grads/{path}"],
                                          got[q][f"{case}/grads/{path}"]), (
                        path, q, r)
    assert pairs


def check_train_step(suite: Suite, runs, case: str) -> None:
    want, got = runs
    gnorms = [got[r][f"{case}/gnorm"] for r in range(4)]
    assert all(np.array_equal(g, gnorms[0]) for g in gnorms), gnorms
    np.testing.assert_allclose(gnorms[0], want[f"{case}/gnorm"],
                               rtol=LOSS_RTOL)
    for key in ("params", "m", "v"):
        for r in range(4):
            for path, mine, top in _blocks(suite, case, key, want, r):
                err = (float(np.abs(got[r][f"{case}/{key}/{path}"]
                                    - mine).max()) / max(top, 1e-30))
                assert err <= GRAD_TOL, (key, r, path, err)
