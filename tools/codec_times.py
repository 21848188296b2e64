"""Time the CUDA codec ops of ``repro_torch`` (``topk_mask``,
``qint8_roundtrip``) at the transport's payload shapes, on one card:

    python3 tools/codec_times.py [--src DIR] [--reps 200]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the one beside this script), so two trees can be compared in
one run on one card. Each shape gets float64 payloads made from a fixed
seed (Gaussian rows at mixed scales, a row of small integers, a zero
row). Prints one JSON line per (op, shape): CUDA-event milliseconds per
call over ``--reps`` warm calls (the host's launch path included), the
profiler's device milliseconds per call, the host microseconds per call
over 10,000 calls (at the main path's widths), the same for the library
yardstick (``torch.topk`` + ``scatter`` for ``topk_mask``; none for
``qint8_roundtrip``), the bytes bound at 3.35 TB/s and whether the kernel is bit-equal to the plain
version; then the card's name and power limit. Needs a CUDA card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

MEM_BYTES_PER_S = 3.35e12
SHAPES = {  # op -> (label, (rows, P), kept)
    "topk_mask": [("h_sk crushed (m, k*k)", (1000, 100), 25),
                  ("the same, kept = P (no search)", (1000, 100), 100),
                  ("grad (m, M)", (1000, 18), 2),
                  ("sg crushed (m, k)", (1000, 10), 5),
                  ("long rows", (1000, 16384), 1639)],
    "qint8_roundtrip": [("h_sk packed (m, k(k+1)/2)", (1000, 55), None),
                        ("grad (m, M)", (1000, 18), None),
                        ("sg (m, k)", (1000, 10), None),
                        ("long rows", (1000, 16384), None)],
}
HOST_REPS = 10_000


def main() -> int:
    here = pathlib.Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(here / "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("codec_times: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / args.reps / 1e3

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(HOST_REPS):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        return (t1 - t0) / HOST_REPS / 1e3

    gen = torch.Generator(device=dev).manual_seed(4)
    for op, shapes in SHAPES.items():
        for label, (rows, p), kept in shapes:
            x = torch.randn(rows, p, generator=gen, dtype=torch.float64,
                            device=dev)
            x = x * 10.0 ** torch.randint(-3, 4, (rows, 1), generator=gen,
                                          device=dev).to(x.dtype)
            x[0] = torch.randint(-3, 4, (p,), generator=gen,
                                 device=dev).to(x.dtype)
            x[1] = 0.0
            u = torch.rand(rows, p, generator=gen, dtype=x.dtype, device=dev)
            item = x.element_size()
            if op == "topk_mask":
                def kern(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="cuda")

                def plain(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="ref")

                def lib(x=x, kept=kept):
                    idx = torch.topk(x.abs(), kept, dim=1).indices
                    return torch.zeros_like(x).scatter_(1, idx,
                                                        x.gather(1, idx))
                read = x.numel() * item
            else:
                def kern(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="cuda")

                def plain(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="ref")
                lib = None
                read = 2 * x.numel() * item
            row = {"src": args.src, "op": op, "shape": label,
                   "dims": [rows, p], "kept": kept,
                   "ms": event_ms(kern), "device_ms": device_ms(kern),
                   "host_us": host_us(kern) if p <= 1024 else None,
                   "library_ms": lib and event_ms(lib),
                   "library_device_ms": lib and device_ms(lib),
                   "library_host_us": (host_us(lib) if lib and p <= 1024
                                       else None),
                   "bound_ms": (read + x.numel() * item) / MEM_BYTES_PER_S * 1e3,
                   "bit_equal": bool(torch.equal(kern(), plain()))}
            print(json.dumps(row), flush=True)
            del x, u
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
