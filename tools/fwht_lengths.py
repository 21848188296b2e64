"""Time the CUDA ``fwht`` of ``repro_torch`` at every power-of-two row
length, at one data size, on one card:

    python3 tools/fwht_lengths.py [--src DIR] [--mib 256] [--srht]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the one beside this script), so two trees can be compared in
one run on one card. Each length moves the same bytes: rows of n values
fill ``--mib`` MiB of float64 (and of float32), read once and written
once. Prints one JSON line per (dtype, n) with CUDA-event milliseconds
over 20 warm calls, the bound at 3.35 TB/s and the kernel's share of it,
then the card's name and power limit. Needs a CUDA card; imports no JAX.

``--srht`` times ``srht_apply`` in float64 instead: at every n of the
forward register route (64 to 2^14; rows of n - n/8 values filling 224
MiB, k = 20), then at SUSY's A_j ((1000, 5000, 18) -> n 32, k 10, the
warp route), covtype's A_j ((200, 2906, 54) -> n 64, k 20) and one
FedNS-like call with one operator ((18000, 5000) -> n 8192, k 10). Each line adds
the profiler's device time per call in all and by kernel, ``x @ S.T``
(events and device time, where S is built) and whether the kernel is
bit-equal to the plain version.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MEM_BYTES_PER_S = 3.35e12
REPS = 20


def _events_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def _device_kernels_ms(torch, fn) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / REPS / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _fwht_lengths(torch, ops, dev, gen, src: str, mib: int) -> None:
    for dtype in (torch.float64, torch.float32):
        total = (mib << 20) // (torch.finfo(dtype).bits // 8)
        for log_n in range(1, 18):
            n = 1 << log_n
            x = torch.randn(total // n, n, dtype=dtype, device=dev,
                            generator=gen)
            ms = _events_ms(torch, lambda: ops.fwht(x, normalize=True,
                                                    impl="cuda"))
            bound = 2 * x.numel() * x.element_size() / MEM_BYTES_PER_S * 1e3
            print(json.dumps({"src": src, "dtype": str(dtype), "n": n,
                              "rows": x.shape[0], "ms": ms,
                              "bound_ms": bound, "share": bound / ms}),
                  flush=True)
            del x


def _srht_shapes(torch, ops, ref, dev, gen, src: str) -> None:
    # (label, x's shape, n, k, whether to time x @ S.T)
    shapes = [(f"n={n} dim={n - n // 8} k=20",
               ((224 << 17) // (n - n // 8), n - n // 8), n, 20, False)
              for n in (1 << p for p in range(6, 15))]
    shapes += [("SUSY A_j n=32 k=10", (1000, 5000, 18), 32, 10, True),
               ("covtype A_j n=64 k=20", (200, 2906, 54), 64, 20, True),
               ("FedNS data axis n=8192 k=10", (18000, 5000), 8192, 10, True)]
    for label, shape, n, k, with_lib in shapes:
        x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        signs = (2 * torch.randint(0, 2, (n,), generator=gen, device=dev)
                 - 1).double()
        rows = torch.randperm(n, generator=gen, device=dev)[:k]
        dense = None  # S (k, dim), the library yardstick's operator
        if with_lib:
            eye = torch.eye(shape[-1], dtype=torch.float64, device=dev)
            dense = ref.srht_apply(eye, signs, rows).T.contiguous()
            del eye

        def kern():
            return ops.srht_apply(x, signs, rows, impl="cuda")
        moved = 8 * (x.numel() + x.numel() // shape[-1] * k + n + k)
        bound = moved / MEM_BYTES_PER_S * 1e3
        ms = _events_ms(torch, kern)
        by_kernel = _device_kernels_ms(torch, kern)
        row = {"src": src, "op": "srht_apply", "shape": label,
               "dims": list(shape), "ms": ms,
               "device_ms": sum(by_kernel.values()),
               "device_kernels_ms": by_kernel, "bound_ms": bound,
               "share": bound / ms, "library_ms": None,
               "library_device_ms": None,
               "bit_equal": bool(torch.equal(
                   kern(), ops.srht_apply(x, signs, rows, impl="ref")))}
        if dense is not None:
            def lib():
                return torch.matmul(x, dense.T)
            row["library_ms"] = _events_ms(torch, lib)
            row["library_device_ms"] = sum(
                _device_kernels_ms(torch, lib).values())
        print(json.dumps(row), flush=True)
        del x, dense


def main() -> int:
    here = pathlib.Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(here / "src"))
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--srht", action="store_true",
                    help="time srht_apply over n and at two main-path shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    from repro_torch.kernels import ops, ref

    if not torch.cuda.is_available():
        print("fwht_lengths: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.srht:
        _srht_shapes(torch, ops, ref, dev, gen, args.src)
    else:
        _fwht_lengths(torch, ops, dev, gen, args.src, args.mib)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
