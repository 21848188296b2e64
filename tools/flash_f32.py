"""Measure the float32 flash-attention path of any tree on one card, for an
A/B against a tree whose ``chip_smoke.py`` lacks these measurements (such
as one before the tf32x3 kernel):

    python3 tools/flash_f32.py [--src DIR] [--part times|prefill|errors]

The ``repro_torch`` under ``--src`` (default: the one beside this script)
is imported, so that another tree is measured by the same code. Parts
(all three when ``--part`` is not given), one JSON line per row, then the
card's name and power limit:

* ``times``: ``ops.flash_attention`` in float32 at the three shapes of
  ``chip_smoke.py``'s ``flash times`` phase, inputs from a fixed seed:
  CUDA-event ms per call over 20 warm calls, the profiler's device ms per
  call over 20 more, and the launches by route of one call.
* ``prefill``: TinyLlama-1.1B at full width and depth in float32 (TF32
  off, random weights from seed 0) timed as ``chip_smoke.py``'s ``serve
  f32`` phase times it: a 2048-token prompt (seed 7, cache 4096), the host
  clock around 5 calls that each end in a synchronize after one warm
  call, the flash launches by route of one call, and one profiled call's
  device time and flash-kernel time.
* ``errors``: the max abs err against the plain version
  (``ref.mha_blocked``), causal, at T = 2048 to 32768 tokens and head dims
  64, 128 and 256 (one KV head), over all rows and over each quarter of
  the rows (a row at position r sees r + 1 keys), with the kernel's ms per
  call over 5 warm calls.

Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# chip_smoke.py's f32 rows of FLASH_TIMED: label, (B, T, H, Hkv, D), window
TIMED = [("TinyLlama prefill causal", (1, 2048, 32, 4, 64), None),
         ("qwen1.5 heads causal", (1, 2048, 64, 8, 128), None),
         ("gemma3-1b local window 512", (1, 2048, 4, 1, 256), 512)]
ERROR_CASES = [(t, h, d) for t in (2048, 4096, 8192, 16384, 32768)
               for h, d in ((4, 64), (4, 128), (2, 256))]  # (T, H, D)


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_kernels(torch, fn) -> list:
    """(kernel name, device µs) of each kernel ``fn`` launches, from the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _flash_launches(ops, fn) -> dict:
    ops.reset_launch_counts()
    fn()
    return {k: v for k, v in ops.launch_counts().items()
            if k.startswith("flash_attention")}


def times(torch, ops, src: str) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    for label, (b, t, h, hkv, d), window in TIMED:
        q = torch.randn(b, t, h, d, generator=gen, device=dev)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev)

        def kern():
            return ops.flash_attention(q, k, v, window=window, impl="cuda")
        kern()
        device = sum(us for _, us in _device_kernels(
            torch, lambda: [kern() for _ in range(20)])) / 20 / 1e3
        print(json.dumps({
            "part": "times", "src": src, "shape": label,
            "dims": [b, t, h, hkv, d], "window": window,
            "ms": _time_ms(torch, kern, 20),
            "device_ms": device,
            "launches": _flash_launches(ops, kern)}), flush=True)


def prefill(torch, ops, src: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.models.lm import LM

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = LM(cfg)
    params = model.init(root_key(0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen, device=dev)

    def run():
        model.prefill(params, {"inputs": tokens}, cache_len=4096)

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _flash_launches(ops, run)
        kernels = _device_kernels(torch, run)
    print(json.dumps({
        "part": "prefill", "src": src, "prefill_ms": ms,
        "prefill_ms_median": sorted(ms)[len(ms) // 2],
        "device_ms": sum(us for _, us in kernels) / 1e3,
        "flash_device_ms": sum(us for name, us in kernels
                               if "flash_attention" in name) / 1e3,
        "flash_launches": launches}), flush=True)
    del model, params
    torch.cuda.empty_cache()


def errors(torch, ops, src: str) -> None:
    dev = torch.device("cuda", 0)
    for t, h, d in ERROR_CASES:
        gen = torch.Generator(device=dev).manual_seed(t + d)
        q = torch.randn(1, t, h, d, generator=gen, device=dev)
        k = torch.randn(1, t, 1, d, generator=gen, device=dev)
        v = torch.randn(1, t, 1, d, generator=gen, device=dev)
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, impl="cuda")
        launches = ops.launch_counts()
        rows = (got - ops.flash_attention(q, k, v, impl="ref")).abs().amax(
            dim=(0, 2, 3))
        print(json.dumps({
            "part": "errors", "src": src, "T": t, "H": h, "Hkv": 1, "D": d,
            "max_abs_err": float(rows.max()),
            "max_abs_err_by_quarter": [
                float(rows[i * t // 4:(i + 1) * t // 4].max())
                for i in range(4)],
            "ms": _time_ms(torch, lambda: ops.flash_attention(
                q, k, v, impl="cuda"), 5),
            "launches": {key: n for key, n in launches.items()
                         if key.startswith("flash_attention")}}), flush=True)
        del q, k, v, got, rows
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--part", choices=("times", "prefill", "errors"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("flash_f32: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 GEMMs and ref
    torch.backends.cudnn.allow_tf32 = False
    for name, part in (("times", times), ("prefill", prefill),
                       ("errors", errors)):
        if args.part in (None, name):
            part(torch, ops, args.src)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
