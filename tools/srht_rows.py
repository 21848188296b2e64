"""Time ``srht_apply_rows`` of ``repro_torch`` (FedNS's data-axis sketch,
A (G, n_rows, M) -> (G, k, M), one operator a client) on one card:

    python3 tools/srht_rows.py [--out FILE] [--ks 10,20,32,64,128]

At the three FedNS shapes (SUSY's A (1000, 5000, 18) -> n 8192 k 10,
covtype's (200, 2906, 54) -> n 4096 k 20, the quickstart's (8, 500, 64)
-> n 512 k 32), in float64 and float32, it times in turns (CUDA events
over warm calls, then the profiler's device time by kernel):

  * ``srht_rows_kernel`` (A read in place) at each slab size that fits,
    the default (``fwht.rows_geometry``) marked;
  * the parent's way: A's contiguous transpose, then the batched
    ``srht_apply`` kernel; the copy and that kernel alone too;
  * ``torch.bmm`` of the dense S_g (G, k, n_rows) with A (the build not
    timed);

beside the bound (A, the signs of its rows and the kept rows read once,
the output written once, at 3.35 TB/s), each checked bit-equal to the plain version. Then,
at SUSY's and covtype's A, the in-place kernel against the parent's way
at each k of ``--ks`` (the route's k limit, ``fwht.ROWS_MAX_K``, is set
from these). Prints one JSON line a row (and writes them to ``--out``),
then the card's name and power limit. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

MEM_BYTES_PER_S = 3.35e12
SHAPES = {"SUSY": ((1000, 5000, 18), 10), "covtype": ((200, 2906, 54), 20),
          "quickstart": ((8, 500, 64), 32)}


def _events_ms(fn, reps: int) -> float:
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


def _device_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (the profiler);
    raises where it sees none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got = {e.key[:80]: e.self_device_time_total / reps / 1e3
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not got:
        raise RuntimeError("the profiler recorded no kernel")
    return got


def _operators(gen, g, n, k, dtype, dev):
    signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=dev)
             - 1).to(dtype)
    rows = torch.topk(torch.rand((g, n), generator=gen, device=dev), k,
                      dim=1).indices.contiguous()
    return signs, rows


def _dense(signs, rows, n_rows):
    """The operators as dense (G, k, n_rows) matrices: S_g[c, i] =
    signs_g[i] (-1)^popcount(rows_g[c] & i) / sqrt(k)."""
    k = rows.shape[1]
    both = rows[:, :, None] & torch.arange(n_rows, device=rows.device)
    parity = torch.zeros_like(both)
    for b in range(int(signs.shape[1]).bit_length()):
        parity ^= (both >> b) & 1
    return ((1 - 2 * parity).to(signs.dtype) * signs[:, None, :n_rows]
            / math.sqrt(k))


def _bound_ms(a, rows, k) -> float:
    g, n_rows, m = a.shape
    item = a.element_size()
    moved = (a.numel() + g * n_rows + g * k * m) * item + rows.numel() * 8
    return moved / MEM_BYTES_PER_S * 1e3


def _shape_rows(label, shape, k, dtype, gen, dev) -> list:
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import srht as ksrht

    g, n_rows, m = shape
    n = 1 << (n_rows - 1).bit_length()
    a = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    signs, rows = _operators(gen, g, n, k, dtype, dev)
    want = ops.srht_apply_rows(a, signs, rows, impl="ref")
    item = a.element_size()
    auto = kfwht.rows_geometry(n, n_rows, m, k, item)[0]
    reps = 20 if a.numel() > 1_000_000 else 200
    at = a.transpose(1, 2).contiguous()
    dense = _dense(signs, rows, n_rows)
    fns = {f"srht_rows_kernel log_p {p}" + (" (default)" if p == auto else ""):
           (lambda p=p: ksrht.srht_rows_kernel(a, signs, rows, log_p=p))
           for p in range(kfwht.ROWS_MAX_LOG_P + 1)
           if kfwht.ROWS_LEAF << p <= n and kfwht.rows_smem(
               p, n_rows, m, k, item) <= kfwht.ROWS_MAX_SMEM}
    fns["parent: transpose copy + srht_apply"] = lambda: ksrht.srht_apply_cuda(
        a.transpose(1, 2).contiguous(), signs, rows).transpose(1, 2)
    fns["transpose copy alone"] = lambda: a.transpose(1, 2).contiguous()
    fns["srht_apply on the copy alone"] = lambda: ksrht.srht_apply_cuda(
        at, signs, rows)
    fns["torch.bmm(S, A)"] = lambda: torch.bmm(dense, a)
    for name, fn in fns.items():
        if name.startswith(("srht_rows", "parent")):
            got = fn()
            if not torch.equal(got, want):
                raise SystemExit(f"{label} {dtype} {name}: differs from the "
                                 f"plain version by {float((got - want).abs().max())}")
    times = {name: [] for name in fns}
    for turn in range(2):  # in turns, forwards then backwards
        for name in (list(fns) if turn == 0 else list(fns)[::-1]):
            times[name].append(_events_ms(fns[name], reps))
    out = []
    bound = _bound_ms(a, rows, k)
    for name, fn in fns.items():
        by_kernel = _device_ms(fn, reps)
        out.append({"shape": label, "dims": list(shape), "n": n, "k": k,
                    "dtype": str(dtype).split(".")[-1], "what": name,
                    "ms": times[name], "device_ms": sum(by_kernel.values()),
                    "device_kernels_ms": by_kernel, "bound_ms": bound})
    return out


def _k_rows(label, shape, ks, gen, dev) -> list:
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import ops
    from repro_torch.kernels import srht as ksrht

    g, n_rows, m = shape
    n = 1 << (n_rows - 1).bit_length()
    a = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    out = []
    for k in ks:
        signs, rows = _operators(gen, g, n, k, torch.float64, dev)
        want = ops.srht_apply_rows(a, signs, rows, impl="ref")
        kern = lambda: ksrht.srht_rows_kernel(a, signs, rows)  # noqa: E731
        parent = lambda: ksrht.srht_apply_cuda(  # noqa: E731
            a.transpose(1, 2).contiguous(), signs, rows).transpose(1, 2)
        smem = kfwht.rows_geometry(n, n_rows, m, k, a.element_size())[1]
        if smem > kfwht.ROWS_MAX_SMEM:  # the kernel cannot take it
            out.append({"shape": label, "dims": list(shape), "n": n, "k": k,
                        "dtype": "float64", "what": "k sweep",
                        "kernel_ms": None, "smem": smem,
                        "parent_ms": [_events_ms(parent, 20)]})
            continue
        if not torch.equal(kern(), want):
            raise SystemExit(f"{label} k {k}: kernel differs from the plain "
                             f"version")
        reps = 20
        ms = {"kernel": [], "parent": []}
        for fn_name in ("kernel", "parent", "parent", "kernel"):
            ms[fn_name].append(_events_ms(kern if fn_name == "kernel"
                                          else parent, reps))
        out.append({"shape": label, "dims": list(shape), "n": n, "k": k,
                    "dtype": "float64", "what": "k sweep",
                    "kernel_ms": ms["kernel"], "parent_ms": ms["parent"],
                    "smem": smem,
                    "bound_ms": _bound_ms(a, rows, k)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "srht_rows.jsonl"))
    ap.add_argument("--ks", default="10,20,32,48,64,96,128,256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    _build.build_all()
    for entry in _build.build_log("srht").split("Compiling entry function")[1:]:
        if "srht_rows_kernel" in entry.split("\n")[0]:
            print("[ptxas] " + " ".join(entry.split()[:40]), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(36)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        def emit(rows):
            for r in rows:
                line = json.dumps(r)
                f.write(line + "\n")
                f.flush()
                print(line, flush=True)
        for dtype in (torch.float64, torch.float32):
            for label, (shape, k) in SHAPES.items():
                emit(_shape_rows(label, shape, k, dtype, gen, dev))
                torch.cuda.empty_cache()
        for label in ("SUSY", "covtype"):
            emit(_k_rows(label, SHAPES[label][0],
                         [int(k) for k in args.ks.split(",")], gen, dev))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
