"""Time the CUDA ``fwht`` of ``repro_torch`` at every power-of-two row
length, at one data size, on one card:

    python3 tools/fwht_lengths.py [--src DIR] [--mib 256]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the one beside this script), so two trees can be compared in
one run on one card. Each length moves the same bytes: rows of n values
fill ``--mib`` MiB of float64 (and of float32), read once and written
once. Prints one JSON line per (dtype, n) with CUDA-event milliseconds
over 20 warm calls, the bound at 3.35 TB/s and the kernel's share of it,
then the card's name and power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MEM_BYTES_PER_S = 3.35e12


def main() -> int:
    here = pathlib.Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(here / "src"))
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("fwht_lengths: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        total = (args.mib << 20) // (torch.finfo(dtype).bits // 8)
        for log_n in range(1, 18):
            n = 1 << log_n
            x = torch.randn(total // n, n, dtype=dtype, device=dev,
                            generator=gen)
            ops.fwht(x, normalize=True, impl="cuda")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                ops.fwht(x, normalize=True, impl="cuda")
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 20
            bound = 2 * x.numel() * x.element_size() / MEM_BYTES_PER_S * 1e3
            print(json.dumps({"src": args.src, "dtype": str(dtype), "n": n,
                              "rows": x.shape[0], "ms": ms,
                              "bound_ms": bound, "share": bound / ms}),
                  flush=True)
            del x
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
