"""Check and time the flash-attention backward kernels on one card, and
hold the forward kernels' outputs and the sm90 backward's gradients of
one tree against another's:

    python3 tools/flash_bwd.py [--src DIR]
                               [--part errors|times|layouts|forward]
                               [--dump FILE] [--compare FILE FILE]

The ``repro_torch`` under ``--src`` (default: the one beside this script)
is imported. Parts (``errors`` and ``times`` when ``--part`` is not
given), one JSON line per row, then the card's name and power limit:

* ``errors``: ``flash_attention_bwd_cuda`` against its plain version
  (``ref.mha_blocked_grad``) at ``chip_smoke.py``'s phase 13 shapes, in
  bfloat16 and float32: the max abs err of dq, dk and dv over the plain
  gradient's max abs value, a second call bit-equal to the first, and
  the forward's output with the log-sum-exp written bit-equal to the
  output without it.
* ``times``: at the same shapes, the backward's route (``sm90`` or
  ``tf32x3``, or an older tree's ``simt``; a tree without
  ``flash_bwd_route`` has only the simt kernels), its CUDA-event ms per
  call and the profiler's device ms by kernel, the plain version's ms,
  SDPA's
  backward (``torch.autograd.grad`` through
  ``F.scaled_dot_product_attention(enable_gqa=True)``, TF32 off) and the
  bound: five products of 2 D flops over the visible pairs at the
  bf16 tensor-core peak (float32: three TF32 products each at the dense
  TF32 peak, and the float32 CUDA-core peak beside it).
* ``layouts``: each route's dk/dv layouts at the shapes it takes (sm90:
  the bfloat16 rows; tf32x3: the float32 rows and bfloat16 at d 60): every
  count of runs of query heads that divides the group, from the whole
  group in one block (1) to a block a head (H / Hkv), set in turn in
  place of the wrapper's rule (``bwd_sm90_splits``,
  ``bwd_tf32x3_splits``), each with its ms, device ms by kernel and max
  error.
* ``forward``: with ``--dump FILE``, the forward kernels' outputs (no
  log-sum-exp) at the flash parity phase's (T, H, Hkv, D) grid and its
  window cases, inputs from seed 5, and the sm90 backward's gradients at
  the bfloat16 shapes above (a head dim that is a multiple of 8), inputs
  from seed 6, saved to FILE; ``--compare A B`` (no card needed) then
  says whether two trees' dumps are bit-equal.

Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (label, (B, T, H, Hkv, D), causal, window): chip_smoke.py's phase 13 (a)
SHAPES = [("TinyLlama heads (1, 2048, 32, 4, 64) causal", (1, 2048, 32, 4, 64),
           True, None),
          ("qwen1.5 heads (1, 2048, 64, 8, 128) causal", (1, 2048, 64, 8, 128),
           True, None),
          ("gemma3-1b local (1, 2048, 4, 1, 256) window 512",
           (1, 2048, 4, 1, 256), True, 512),
          ("TinyLlama training (2, 2048, 32, 4, 64) causal",
           (2, 2048, 32, 4, 64), True, None),
          ("bf16 head dim 60 (1, 1024, 8, 2, 60) causal", (1, 1024, 8, 2, 60),
           True, None)]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
MEM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
F32_OPS_PER_S = 67e12
# flash parity's forward cases: (T, H, Hkv, D, window)
FORWARD = [(t, h, hkv, d, None) for t in (64, 100, 2048)
           for h, hkv in ((4, 4), (8, 1), (32, 4)) for d in (64, 128, 256)]
FORWARD += [(100, 4, 4, 64, 1), (100, 8, 1, 128, 7), (2048, 4, 1, 256, 512),
            (2048, 16, 2, 128, 512), (2048, 8, 2, 256, 128)]


def visible_pairs(t: int, window) -> int:
    """Query-key pairs of a causal (windowed) self-attention of length t."""
    return sum(min(r + 1, window or r + 1) for r in range(t))


def bwd_bound_ms(b, t, h, hkv, d, window, dtype_name) -> dict:
    """The backward's least time: five products of 2 d flops a visible
    pair and head, against q, k, v, o, dO and lse read once and dq, dk,
    dv written once."""
    item = 2 if dtype_name == "bfloat16" else 4
    io = (4 * b * t * h * d + 4 * b * t * hkv * d) * item + b * h * t * 4
    flops = 10 * d * b * h * visible_pairs(t, window)
    t_bytes = io / MEM_BYTES_PER_S * 1e3
    if dtype_name == "bfloat16":
        t_ops = flops / BF16_OPS_PER_S * 1e3
        simt = None
    else:
        t_ops = 3 * flops / TF32_OPS_PER_S * 1e3
        simt = max(t_bytes, flops / F32_OPS_PER_S * 1e3)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "simt_bound_ms": simt, "gflop": flops / 1e9}


def _inputs(torch, gen, b, t, h, hkv, d, dtype, dev):
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _route(kflash, dtype, d) -> str:
    route = getattr(kflash, "flash_bwd_route", None)
    return route(dtype, d) if route else "simt"


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


def _device_kernels_ms(torch, fn, reps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def part_errors(torch, kflash, ref, dev) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator(device=dev).manual_seed(13)
        for label, (b, t, h, hkv, d), causal, window in SHAPES:
            q, k, v, do = _inputs(torch, gen, b, t, h, hkv, d, dtype, dev)
            out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                                       q_offset=0, block_k=1024, with_lse=True)
            plain_out = kflash.flash_attention_cuda(q, k, v, causal=causal,
                                                    window=window)
            got = kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                  causal=causal, window=window)
            again = kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                    causal=causal, window=window)
            want = ref.mha_blocked_grad(q, k, v, do, causal=causal,
                                        window=window)
            torch.cuda.synchronize()
            errs = {g: rel_err(x, w) for g, x, w in zip(("dq", "dk", "dv"),
                                                        got, want)}
            row = {"part": "errors", "dtype": name, "shape": label,
                   "route": _route(kflash, dtype, d), "rel_err": errs,
                   "tol": TOL[name],
                   "repeats_bitwise": all(bool(torch.equal(x, y))
                                          for x, y in zip(got, again)),
                   "forward_lse_bitwise": bool(torch.equal(out, plain_out)),
                   "lse_finite": bool(torch.isfinite(lse).all())}
            row["ok"] = (max(errs.values()) <= TOL[name]
                         and row["repeats_bitwise"]
                         and row["forward_lse_bitwise"] and row["lse_finite"])
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, do, out, lse, got, again, want
            torch.cuda.empty_cache()
    return rows


def part_times(torch, kflash, ref, dev) -> list:
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator(device=dev).manual_seed(14)
        for label, (b, t, h, hkv, d), causal, window in SHAPES:
            q, k, v, do = _inputs(torch, gen, b, t, h, hkv, d, dtype, dev)
            out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                                       q_offset=0, block_k=1024, with_lse=True)

            def kern():
                return kflash.flash_attention_bwd_cuda(
                    q, k, v, out, do, lse, causal=causal, window=window)

            def plain():
                return ref.mha_blocked_grad(q, k, v, do, causal=causal,
                                            window=window)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            if window:
                pos = torch.arange(t, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (
                    pos[None, :] > pos[:, None] - window)
                lib_out = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            else:
                lib_out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            do_t = do.transpose(1, 2)

            def lib():
                return torch.autograd.grad(lib_out, (qt, kt, vt), do_t,
                                           retain_graph=True)
            by_kernel = _device_kernels_ms(torch, kern, 10)
            row = {"part": "times", "dtype": name, "shape": label,
                   "dims": [b, t, h, hkv, d], "window": window,
                   "route": _route(kflash, dtype, d),
                   "ms": _time_ms(torch, kern, 10),
                   "device_ms": sum(by_kernel.values()),
                   "device_ms_by_kernel": by_kernel,
                   "plain_ms": _time_ms(torch, plain, 2),
                   "library": "SDPA backward (enable_gqa=True)",
                   "library_ms": _time_ms(torch, lib, 10),
                   "library_device_ms": sum(
                       _device_kernels_ms(torch, lib, 10).values()),
                   **bwd_bound_ms(b, t, h, hkv, d, window, name)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, do, out, lse, qt, kt, vt, lib_out
            torch.cuda.empty_cache()
    return rows


def part_layouts(torch, kflash, ref, dev) -> list:
    rows = []
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = [(torch.bfloat16, shape) for shape in SHAPES]
    cases += [(torch.float32, shape) for shape in SHAPES]
    for dtype, (label, (b, t, h, hkv, d), causal, window) in cases:
        route = _route(kflash, dtype, d)
        name = f"bwd_{route}_splits"
        if not hasattr(kflash, name):
            continue
        rule = getattr(kflash, name)
        q, k, v, do = _inputs(torch, gen, b, t, h, hkv, d, dtype, dev)
        out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                                   q_offset=0, block_k=1024, with_lse=True)
        want = ref.mha_blocked_grad(q, k, v, do, causal=causal, window=window)

        def kern():
            return kflash.flash_attention_bwd_cuda(
                q, k, v, out, do, lse, causal=causal, window=window)
        for splits in [s for s in range(1, h // hkv + 1) if h // hkv % s == 0]:
            # the wrapper reads its rule at every call: each layout in turn
            setattr(kflash, name, lambda *shape, n=splits: n)
            try:
                got = kern()
                by_kernel = _device_kernels_ms(torch, kern, 10)
                ms = _time_ms(torch, kern, 10)
            finally:
                setattr(kflash, name, rule)
            tile = (kflash.BWD_SM90_TILE if route == "sm90" else
                    kflash.BWD_TF32X3_TILE[next(w for w in (64, 128, 256)
                                                if d <= w)])
            tiles = -(-t // tile)
            row = {"part": "layouts", "shape": label,
                   "dtype": str(dtype).split(".")[-1], "route": route,
                   "dims": [b, t, h, hkv, d], "splits": splits,
                   "rule": rule(b, t, h, hkv, d),
                   "dkdv_blocks": b * hkv * splits * tiles, "ms": ms,
                   "device_ms": sum(by_kernel.values()),
                   "device_ms_by_kernel": by_kernel,
                   "rel_err": max(rel_err(x, w) for x, w in zip(got, want))}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, want
        torch.cuda.empty_cache()
    return rows


def part_forward(torch, kflash, dev, dump: str) -> None:
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(5)
        for t, h, hkv, d, window in FORWARD:
            q, k, v, _ = _inputs(torch, gen, 1, t, h, hkv, d, dtype, dev)
            out = kflash.flash_attention_cuda(q, k, v, window=window)
            outs[f"{dtype} {t} {h} {hkv} {d} {window}"] = out.cpu()
    gen = torch.Generator(device=dev).manual_seed(6)
    for label, (b, t, h, hkv, d), causal, window in SHAPES:
        if d % 8:
            continue
        q, k, v, do = _inputs(torch, gen, b, t, h, hkv, d, torch.bfloat16,
                              dev)
        out, lse = kflash._forward(q, k, v, causal=causal, window=window,
                                   q_offset=0, block_k=1024, with_lse=True)
        grads = kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                causal=causal, window=window)
        for g, x in zip(("dq", "dk", "dv"), grads):
            outs[f"backward {label} {g}"] = x.cpu()
    torch.save(outs, dump)
    print(json.dumps({"part": "forward", "dump": dump, "cases": len(outs)}))


def compare(torch, a: str, b: str) -> int:
    da, db = torch.load(a), torch.load(b)
    same = sorted(da) == sorted(db) and all(torch.equal(da[n], db[n])
                                            for n in da)
    print(json.dumps({"part": "compare", "a": a, "b": b,
                      "cases": len(da), "bitwise": same}))
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--part", choices=("errors", "times", "layouts",
                                       "forward"))
    ap.add_argument("--dump")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if args.compare:
        return compare(torch, *args.compare)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as kflash

    dev = torch.device("cuda", 0)
    if args.part == "forward":
        part_forward(torch, kflash, dev, args.dump)
    else:
        from repro_torch.kernels import ref

        ok = True
        if args.part in (None, "errors"):
            ok = all(r["ok"] for r in part_errors(torch, kflash, ref, dev))
        if args.part in (None, "times"):
            part_times(torch, kflash, ref, dev)
        if args.part == "layouts":
            part_layouts(torch, kflash, ref, dev)
        if not ok:
            print("backward errors out of tolerance", file=sys.stderr)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0 if args.part == "forward" or ok else 1


if __name__ == "__main__":
    sys.exit(main())
