"""Time gloo's collectives over CUDA tensors between ranks on one card,
the transport of ``repro_torch.sharding.tensor_parallel`` there:

    python3 tools/gloo_collectives.py [--ranks 2] [--mib 256] [--reps 3]

Starts ``--ranks`` processes (gloo over a ``FileStore`` under a
temporary directory, one card), and in each times ``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` of a float32
buffer of ``--mib`` MiB (the all-gather's and the reduce-scatter's
whole result or input that size), then the same all-reduce and
reduce-scatter cut in ``tensor_parallel.STRIPES`` stripes over as many
groups in flight at once. Prints one JSON line per collective: the
median host seconds of ``--reps`` calls after a warm one (each ends in
``torch.cuda.synchronize``) on rank 0, and the card's name and power
limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

STRIPES = 4


def _timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)[len(out) // 2]


def _striped(op, flat: torch.Tensor, groups) -> None:
    bounds = [flat.numel() * i // len(groups) for i in range(len(groups) + 1)]
    works = [op(flat[bounds[i]:bounds[i + 1]], groups[i])
             for i in range(len(groups))]
    for w in works:
        w.wait()


def rank_main(rank: int, ranks: int, store: str, mib: int, reps: int) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, ranks),
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    n = mib * (1 << 20) // 4
    buf = torch.ones(n, device="cuda")
    part = torch.empty(n // ranks, device="cuda")
    groups = [dist.new_group(list(range(ranks))) for _ in range(STRIPES)]
    rows = buf.view(ranks, -1)
    rows_out = part

    def rs_striped():
        # each stripe reduce-scatters its columns of every rank's block
        cols = rows.shape[1]
        bounds = [cols * i // STRIPES for i in range(STRIPES + 1)]
        works = [dist.reduce_scatter_tensor(
            rows_out[bounds[i]:bounds[i + 1]],
            rows[:, bounds[i]:bounds[i + 1]].contiguous().view(-1),
            group=groups[i], async_op=True) for i in range(STRIPES)]
        for w in works:
            w.wait()
    runs = {
        "all_reduce": lambda: dist.all_reduce(buf),
        "all_gather": lambda: dist.all_gather_into_tensor(buf, part),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(part, buf),
        f"all_reduce x{STRIPES} stripes": lambda: _striped(
            lambda x, g: dist.all_reduce(x, group=g, async_op=True), buf,
            groups),
        f"reduce_scatter x{STRIPES} stripes": rs_striped}
    for name, fn in runs.items():
        s = _timed(fn, reps)
        if rank == 0:
            print(json.dumps({"collective": name, "ranks": ranks,
                              "mib": mib, "dtype": "float32",
                              "median_s": s, "reps": reps}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.store, args.mib, args.reps)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        store = str(pathlib.Path(tmp) / "store")
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                   "--ranks", str(args.ranks), "--store",
                                   store, "--mib", str(args.mib), "--reps",
                                   str(args.reps)])
                 for r in range(args.ranks)]
        codes = [p.wait(timeout=900) for p in procs]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return max(abs(c) for c in codes)


if __name__ == "__main__":
    sys.exit(main())
