"""Time TinyLlama-1.1B's decode step served over a (2 data, 2 model) mesh
of 4 gloo ranks on one card, for an A/B of two trees in one call:

    python3 tools/mesh_decode.py [--src DIR ...] [--pairs 4] [--steps 12]

Each ``--src`` names a ``src`` directory whose ``repro_torch`` is timed
(default: the one beside this script); with several, their runs
alternate ``--pairs`` times. A run starts 4 processes (gloo over a
``FileStore`` under a temporary directory), draws the whole model in
bf16 from seed 0 one rank after another, keeps each rank's serving shard
(``rules.serving_shard``), prefills 4 prompts of 512 tokens (a cache of
530 slots) and times ``--steps`` teacher-forced decode steps, each
ending in ``torch.cuda.synchronize``. Prints one JSON line a run: the
median ms a step after the first on rank 0 and its host ms a step in
each collective kind (``tensor_parallel.collective_seconds``); then the
card's name and power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent


def rank_main(src: str, rank: int, store: str, steps: int, label: str) -> None:
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models.lm import LM
    from repro_torch.sharding import rules
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.ctx import use_mesh

    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 512), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab, (steps, 4, 1), generator=gen,
                           device="cuda")
    with process_group(rank, 4, store, backend="gloo", timeout_s=300):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        for turn in range(4):
            if turn == rank:
                params = model.init(root_key(0, device="cuda"))
                local = rules.serving_shard(mesh, params)
                del params
                torch.cuda.empty_cache()
            dist.barrier()
        with use_mesh(mesh), torch.no_grad():
            _, state = model.prefill(local, {"inputs": toks}, cache_len=530)
            torch.cuda.synchronize()
            ms = []
            tp.reset_moved_bytes()
            for step in forced:
                t0 = time.perf_counter()
                _, state = model.decode_step(local, state, step)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            coll = {k: v * 1e3 / steps
                    for k, v in tp.collective_seconds().items() if v}
        if rank == 0:
            tail = sorted(ms[1:])
            print(json.dumps({"label": label, "src": src,
                              "decode_ms_median": tail[len(tail) // 2],
                              "collective_ms_per_step": coll}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    srcs = args.src or [str(HERE.parent / "src")]
    if args.rank is not None:
        rank_main(srcs[0], args.rank, args.store, args.steps, args.label)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    code = 0
    for i in range(args.pairs):
        for j, src in enumerate(srcs):
            with tempfile.TemporaryDirectory() as tmp:
                procs = [subprocess.Popen(
                    [sys.executable, __file__, "--src", src, "--rank", str(r),
                     "--store", str(pathlib.Path(tmp) / "store"), "--steps",
                     str(args.steps), "--label", f"src{j} run{i}"])
                    for r in range(4)]
                code = max([code] + [abs(p.wait(timeout=900)) for p in procs])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return code


if __name__ == "__main__":
    sys.exit(main())
