"""Drive repro_torch on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device   — require CUDA and compute capability 9.x; print the card's
                name and power limit (nvidia-smi)
  2. build    — build the CUDA kernels from src/repro_torch/kernels/csrc
                and import the libraries of srht.cu and codec.cu as the
                extension modules repro_srht and repro_codec; print the
                registers and spills (ptxas) of both flash kernels per
                instantiation (the tf32x3 one may not spill at D <= 128),
                of every codec kernel instantiation and of the forward
                SRHT's and the strided pass's register kernels (none of
                these may spill)
  3. parity   — hold fwht, srht_apply and srht_apply_t against their
                plain PyTorch versions on the card, in float32 and
                float64, at power-of-two and padded dims (dim = n - 1
                too), batched, at the quickstart's, the full-size SUSY,
                covtype and phishing shapes and on both sides of every
                route boundary (fwht.kernel_route), k = 1 and k = n, at
                (2000, 5000) -> n 8192 (more chunks than one wave of
                blocks, so each block walks several), with signs other
                than +1 and -1 on every route, and srht_apply on views of
                x off a 16-byte boundary; then srht_apply with one operator
                per leading index (signs (G, n), rows (G, k)) on every
                forward route: one row an operator, odd groups, groups
                that straddle a chunk, k = 1 and k = n, the FedNS shapes,
                signs other than +-1 and a view off a 16-byte boundary:
                bit-equality required (the kernels keep the plain
                versions' op order and are built with -fmad=false)
  4. quickstart — FLeNS at the quickstart size (n=4000, dim=64, m=8,
                k=32, float64, 12 rounds) through the kernels; launch
                counts checked per round (3 srht_apply + 2 srht_apply_t,
                one batched launch per call site); the trajectory must
                equal the same run through the plain versions on the card
  5. full size — the SUSY twin at the real row count (n=5,000,000, M=18,
                m=1000, k=10, lam=1e-3, float64): newton_solve, then FLeNS
                for 10 rounds; gap per round, ms per round, peak memory,
                and each kernel's time at its main-path shapes beside its
                bound, the plain version and the library yardstick
                (srht_apply_t also at the quickstart's shapes, fwht also at
                (64, 2^14)); for fwht and srht_apply_t the profiler's
                device time and the kernel that serves the shape, and for
                srht_apply_t the host's launch path step by step (10,000
                calls a step) beside the parent commit's way of each step
 5b. covtype  — the covtype twin at the real UCI row count (n=581,012,
                M=54, m=200, k=20, lam=1e-3, spectrum_decay 1.8, float64):
                newton_solve, then FLeNS for 10 rounds through the kernels
                (3 srht_apply + 2 srht_apply_t launches a round) with the
                trajectory equal to the plain versions' on the card; gap
                per round, ms per round (run_rounds and bare), peak memory,
                a profiled round's device busy share and top kernels; then
                srht_apply at covtype's three main-path shapes, phishing's
                (11,055 rows, M=68, m=40, k=17), the quickstart's and one
                FedNS-like call ((18,000, 5,000) -> n 8192, k 10, one
                operator), each with its route, events time, the profiler's
                device time in all and by kernel, the bound, the plain
                version and x @ S.T, and bit-equal to the plain version
  5c. table-I — the nine other Table-I optimizers (FedAvg, FedProx,
                FedNewton, DistributedNewton, LocalNewton, FedNew, FedNL,
                FedNS with k=10, FedNDES) on the SUSY problem at full size,
                10 rounds each with comm=None: loss finite and gap falling,
                gap per round, ms per round (run_rounds and bare), peak
                memory; FedNS and FedNDES launch one batched srht_apply a
                round and their trajectories equal the plain versions' on
                the card (each with a profiled round); then the batched
                srht_apply at the three FedNS shapes (SUSY 1000 x 18 rows
                of 5000 -> n 8192, k 10; covtype 200 x 54 of 2906 -> 4096,
                k 20; the quickstart 8 x 64 of 500 -> 512, k 32): events,
                the profiler's device time by kernel, the transpose copy
                of A on its own, the bound, the plain version and torch.bmm
                of dense per-client S; and FedNS srht:fixed under one
                CommConfig at the quickstart size, its trajectory, bytes
                and traces equal to the plain versions'
 5d. async   — FLeNS+ at SUSY's size on the straggler channel: the
                full-quorum anchor bit-equal to sync, then sync, async_buf
                (K = m/4), async_q50 and async_buf under comp+sched+ef,
                launches checked (4 srht_apply + 3 srht_apply_t a group
                round, one probe round a run), trajectories equal to the
                plain versions', ms a commit with the event loop apart
 5e. populations — the lock-step anchor across the population drivers at
                m = 200, then a child process: m = 100,000 at q = 1e-3
                under the edge codecs with EF (sync and async) and SUSY's
                rows as a DatasetPopulation, against host and device
                budgets; the child also runs 5f's two population drivers
                and 5g's population rows
 5f. telemetry — run_rounds with obs=TelemetryConfig(sink="jsonl:...")
                on five drivers: FLeNS without transport (10 rounds),
                FLeNS+ under comp+sched+ef on the edge channel (10 rounds,
                its first two profiled), async_buf (K = m/4) on the
                straggler channel (20 commits) at SUSY's full size, and
                the m = 100,000 population's sync (10 rounds) and async
                (10 commits) runs from the 5e child: each trajectory
                bit-equal to the run with telemetry off, the launches
                checked, the JSONL accepted by repro_torch.obs.report
                --check-schema; compile_s, exec_s_per_round, phase_s and
                the flight stats printed, with ms a step with telemetry
                off, on with the null sink and on with the jsonl sink (three
                turns each); the profiler's Chrome trace must name
                srht_fwd_warp_kernel, srht_t_warp_kernel,
                topk_mask_warp_kernel and qint8_warp_kernel at 2 x (4 / 3
                / 1 / 3) launches (streams and traces under
                chiprun_out/telemetry/)
 5g. dynamics — FLeNS+ at SUSY's full size under scenario dynamics
                (repro_torch.dynamics), telemetry on: churn (poisson:0.05)
                with a diurnal uplink (sin:24,0.5) and regional outages
                (outage:0.05,3,16) under comp+sched+ef on the edge
                channel, sync 10 rounds (its first two profiled: the trace
                must name the four warp kernels at 2 x (4 / 3 / 1 / 3)
                launches) and async_buf (K = m/4) 20 commits; then
                bench_robust's arms (clean, signflip:0.1, signflip:0.1 with
                trimmed:0.1) under the dense codecs on the straggler
                channel, sync 10 rounds each; and from the 5e child, the
                m = 100,000 population rows of examples/edge_clients.py
                at uniform:1e-3, 10 rounds each (churn; clean, noise:0.1,5
                and noise:0.1,5 with trimmed:0.1 under the dense codecs).
                Each run: launches checked, the trajectory and the dynamics
                counters bit-equal to the plain versions' on the card, the
                counters (robust_stats, clients_departed, uploads_retired)
                and the alive count printed; the arms of a comparison
                transmit equal bytes (checked), their final-loss gaps to
                the clean run printed; bare ms a step with dynamics off and
                on in turns (off, on, on, off) printed beside each other
 6. long rows — fwht, srht_apply and srht_apply_t past the single-pass
                length (n = 2^15, 2^17, 2^20) against their plain versions,
                bit-equal; fwht timed at (64, 2^17) and (1, 2^20),
                srht_apply at (2, 2^17) with dim 2^17 - 5, each with the
                profiler's device time by kernel (the two passes apart)
  7. codec parity — topk_mask and qint8_roundtrip against their plain
                versions, bit-equal, in float32 and float64: the main-path
                payload shapes, ties, zero rows, kept = 1 and P, ragged
                widths, the warp routes' limit (P = 1024) and one past it,
                and long rows that are streamed
  8. transport — FLeNS+ at the SUSY size under two transports of
                examples/edge_clients.py (comp+sched+ef, crush+rot+ef) on
                its edge channel, 10 rounds each: codec launches per round
                as the codec chains imply, the guarded loss finite and
                never rising, the same trajectory and byte axis through
                the plain versions on the card; bytes, simulated seconds,
                ms per round, peak memory, and the codec kernels' times
                (events and the profiler's device time, with the kernel
                that serves each shape) beside their bounds, plain
                versions and library yardstick, and the host's launch path
                of qint8_roundtrip at (1000, 55) step by step beside the
                parent commit's ctypes way
  9. flash parity — the flash-attention kernels against their plain
                version (ref.mha_blocked): bfloat16 through the tensor-core
                kernel (route sm90, max abs err <= 2e-2), float32 through
                the 3xTF32 tensor-core kernel (route tf32x3, <= 2e-5), each
                launch counted on its route: (tq, tk) in (64, 64), (100,
                100), (32, 96),
                (1, 128), (2048, 2048) x (H, Hkv) in (4, 4), (8, 1),
                (32, 4) x D in 64, 128, 256, then windows 1, 7, 128, 512
                (D 128 and 256 at 2048), D 8 and 112, non-causal, q_offset
                with a window, rows with no key, causal rows of up to 4096
                and 8192 keys (D 64, 128); then head dims that are
                not a multiple of 8 (D 12, 13, 200 in float32; D 12, 13 in
                bfloat16, which TMA cannot stride) through the tf32x3
                kernel
 10. serve    — TinyLlama-1.1B at full width and depth (22 layers, bf16,
                random weights from seed 0) through ServingEngine
                (max_batch 4, cache_len 4096): 8 requests, prompts of
                100-2000 tokens (numpy seed 0), 64 new tokens each; every
                request completes, 22 launches of the tensor-core kernel per
                prefill (none of the tf32x3 one) and none in decode; the
                last-position logits of a 2048-token prefill
                through the kernel and the plain version within 4 bf16
                ulps of the largest logit; prefill ms by bucket (128 to
                2048), decode ms per step at batch 4 and its profile,
                engine tokens/s, peak memory, and the kernel's profiled
                share of a 2048-token prefill
 11. serve f32 — the same model in float32 (TF32 off), 22 tf32x3-kernel
                launches per prefill (none of the sm90 one): every
                request's engine tokens equal its isolated prefill + greedy
                decode; engine tokens/s, the 2048-token prefill's ms and
                its profile (device time, the flash kernel's share)
 12. flash times — the tensor-core kernel, its plain version and
                F.scaled_dot_product_attention at (1, 2048, 32, 4, 64)
                causal, (1, 2048, 4, 1, 256) window 512 and (1, 2048, 64,
                8, 128) causal, bf16, beside the bound; the tf32x3 kernel
                at the same three shapes in float32, beside its bound (three
                times the operations at the 494.7 TFLOP/s dense TF32 tensor
                rate) and the float32 SIMT one (67 TFLOP/s), SDPA with TF32
                off
 13. train    — LM training through the flash-attention backward kernel
                (csrc/flash_attention_bwd.cu): (a) the backward against its
                plain version (ref.mha_blocked_grad) at (1, 2048, 32, 4,
                64) and (1, 2048, 64, 8, 128) causal, (1, 2048, 4, 1, 256)
                window 512 and the training shape (2, 2048, 32, 4, 64), in
                bfloat16 (<= 2e-2 of each gradient's max |value|) and
                float32 (<= 1e-4), a second call bit-equal, the forward's
                output bit-equal with its log-sum-exp written and not (also
                over flash parity's self-attention shapes), timed beside its
                bound, its plain version and SDPA's backward; (b)
                TinyLlama-1.1B at full width and depth in bf16 with remat,
                batch 2 x 2048 tokens from FastLMStream, 12 AdamW steps with
                launch/train.py's schedule, through the kernels (2 forward
                launches and 1 backward a layer a step) and through the
                plain versions from the same init: every CE finite, the
                trajectories and step 0's gradients within the stated
                tolerances, the last CE below the first; ms a step,
                tokens/s, peak memory and a profiled step's busy share and
                backward-kernel share; (c) the float32 twin at full width
                and 4 layers (the tf32x3 forward), the same checks at tight
                tolerances; (d) the FLeNS head (m = 8, 64 sequences of 32
                tokens a client, k = 64) on the trained bf16 backbone's
                features (D = 2048): FLeNS through the SRHT kernels
                bit-equal to the plain versions, with FedAvg and FedNewton
 14. kernels  — one JSON line naming every ported kernel (flash
                attention as two entries: the sm90 route and the tf32x3
                route; its backward as a third); the srht_apply and fwht
                entries list their routes, each with a timed shape and its
                bound (srht_apply's batched routes at the three FedNS shapes
                too)

The last line of standard output is the device record
``{"ok": true, "device": {...}}``; before it come the card's name and
power limit, the kernels line, and the whole run's record as one JSON
line prefixed ``[record]``.

The script imports nothing of JAX; it finds the port under src/ next to
itself and fails when run anywhere else.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, the vector (non
# tensor-core) rates the butterfly and codec kernels run on, and the
# dense bf16 tensor-core rate that bounds attention on bf16 inputs
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12,
                  torch.bfloat16: 989e12}
# the dense TF32 tensor-core rate: the tf32x3 flash kernel does three TF32
# products for each float32 one
TF32_OPS_PER_S = 494.7e12

SUSY = dict(n=5_000_000, dim=18, m=1000, k=10, lam=1e-3,
            spectrum_decay=1.5, label_noise=0.05)
QUICK = dict(n=4000, dim=64, m=8, k=32, lam=1e-3)
# paper Table II covtype at the real UCI row count (repro's twin cuts it
# to 58,101 rows for the CPU) and phishing (its real size)
COVTYPE = dict(n=581_012, dim=54, m=200, k=20, lam=1e-3, spectrum_decay=1.8,
               label_noise=0.05)
PHISHING = dict(n=11_055, dim=68, m=40, k=17)

KERNELS = {
    "fwht": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                 replaces="src/repro/kernels/fwht.py:51"),
    "srht_apply": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                       replaces="src/repro/kernels/srht.py:98"),
    "srht_apply_t": dict(source="src/repro_torch/kernels/csrc/srht.cu",
                         replaces="src/repro/kernels/srht.py:130"),
    "topk_mask": dict(source="src/repro_torch/kernels/csrc/codec.cu",
                      replaces="src/repro/kernels/codec_kernels.py:85"),
    "qint8_roundtrip": dict(source="src/repro_torch/kernels/csrc/codec.cu",
                            replaces="src/repro/kernels/codec_kernels.py:112"),
    "flash_attention_sm90": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    "flash_attention_tf32x3": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72"),
    # no Pallas backward: the reference differentiates mha_blocked's jnp
    # ops, reached from its attention
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:104"),
}
NO_CODEC = {"topk_mask": 0, "qint8_roundtrip": 0}
# (operators G, rows a operator as an inner batch, dim, n, k): batched
# srht_apply on every forward route (n <= 32, 33..2^14, past 2^14): one
# row an operator, odd groups, groups that straddle a chunk of the
# register kernel (13 rows of n = 64, whose chunks hold 64 rows), k = 1
# and k = n, and the three FedNS shapes cut in operators
BATCHED = [(5, (1,), 18, 32, 10), (7, (3,), 30, 32, 1), (3, (33,), 32, 32, 32),
           (9, (13,), 54, 64, 20), (4, (65,), 63, 64, 64), (3, (7,), 500, 512, 1),
           (6, (64,), 500, 512, 32), (3, (54,), 2906, 4096, 20),
           (11, (18,), 5000, 8192, 10), (2, (3,), 16383, 16384, 16384),
           (3, (2,), 20000, 1 << 15, 64), (2, (1,), (1 << 17) - 5, 1 << 17, 300)]
# the nine Table-I baselines at examples/federated_logreg.py's settings,
# FedNS at SUSY's k (paper Table II)
TABLE_ONE = [("fedavg", dict(lr=2.0, local_steps=5)),
             ("fedprox", dict(lr=2.0, local_steps=5, mu_prox=0.01)),
             ("fednewton", {}), ("distributed_newton", {}),
             ("local_newton", {}), ("fednew", {}), ("fednl", {}),
             ("fedns", dict(k=SUSY["k"])), ("fedndes", {})]
SKETCHED = ("fedns", "fedndes")  # one batched srht_apply launch a round
NO_BWD = {"flash_attention_bwd": 0, "flash_attention_bwd_delta": 0,
          "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0}
NO_LM = {"flash_attention": 0, "flash_attention_sm90": 0,
         "flash_attention_tf32x3": 0, **NO_BWD}

# examples/edge_clients.py: name -> (sketch, codecs, uplink bytes per
# delivering client at k=10, M=18)
TRANSPORTS = {
    "comp+sched+ef": ("srht", {"h_sk": "sympack+qint8", "sg": "qint8",
                               "grad": "topk0.1+qint8"}, 59 + 14 + 14 + 8),
    "crush+rot+ef": ("srht:rotate=6", {"h_sk": "topk0.25", "sg": "topk0.5",
                                       "grad": "topk0.1+qint8"},
                     300 + 60 + 14 + 8),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    major, minor = torch.cuda.get_device_capability(0)
    check(major == 9, f"needs compute capability 9.x, card has {major}.{minor}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} capability "
        f"{major}.{minor}, torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build_all()
    _build.library()
    _build.module()  # srht.cu is also the extension module repro_srht
    _build.module("codec")  # and codec.cu the extension module repro_codec
    total = time.perf_counter() - t0
    log(f"[build] {total:.2f} s ({per_source or 'already built'})")
    # ptxas -v of the tensor-core flash kernel: one entry per head-dim width
    ptxas = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention_sm90"))[1:]:
        name = re.search(r"kernelILi(\d+)E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable ptxas report")
        key = f"D{name.group(1)}"
        ptxas[key] = {"registers": int(regs.group(1)),
                      "spill_stores": int(spill.group(1)),
                      "spill_loads": int(spill.group(2))}
        log(f"[build] flash_attention_sm90_kernel {key}: {ptxas[key]}")
    check(len(ptxas) == 3, f"build: expected 3 sm90 instantiations, got "
          f"{sorted(ptxas)}")
    # the tf32x3 flash kernel: per input type, head-dim width and load path
    # (cp.async or plain loads); no spill at D <= 128
    tf32x3 = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention"))[1:]:
        name = re.search(r"tf32x3_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                         entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable tf32x3 ptxas report")
        dt, width, cp = name.groups()
        key = (f"{'float' if dt == 'f' else 'bf16'} D{width} "
               f"{'cp.async' if cp == '1' else 'plain loads'}")
        tf32x3[key] = {"registers": int(regs.group(1)),
                       "spill_stores": int(spill.group(1)),
                       "spill_loads": int(spill.group(2))}
        log(f"[build] flash_attention_tf32x3_kernel {key}: {tf32x3[key]}")
        check(int(width) > 128 or tf32x3[key]["spill_stores"]
              == tf32x3[key]["spill_loads"] == 0,
              f"build: tf32x3 {key} spills: {tf32x3[key]}")
    check(len(tf32x3) == 9, f"build: expected 9 tf32x3 instantiations, got "
          f"{sorted(tf32x3)}")
    # the codec kernels: the warp routes' per dtype and register count
    # (values a lane), whose limit holds only without spills, and the
    # block routes' (qint8_kernel with and without 16-byte loads)
    codec = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("codec"))[1:]:
        name = re.search(r"(topk_mask_warp|qint8_warp|topk_mask|qint8)"
                         r"_kernelI([df])(?:Li(\d+)E|Lb([01])E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable codec ptxas report")
        kind, dt, values, vec = name.groups()
        args = ["double" if dt == "d" else "float"]
        if values:
            args.append(values)
        if vec:
            args.append("16-byte" if vec == "1" else "single")
        key = f"{kind}_kernel<{', '.join(args)}>"
        codec[key] = {"registers": int(regs.group(1)),
                      "spill_stores": int(spill.group(1)),
                      "spill_loads": int(spill.group(2))}
        check(codec[key]["spill_stores"] == codec[key]["spill_loads"] == 0,
              f"build: {key} spills: {codec[key]}")
    check(len(codec) == 30, f"build: expected 30 codec kernel instantiations, "
          f"got {sorted(codec)}")
    log("[build] codec kernels, registers (no spills): " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(codec.items())))
    # the SRHT source's register kernels: the forward one per dtype, LOG_N
    # (6..14) and operator form (one, or one per group of rows), the
    # strided pass per dtype and LOG_R (1..14)
    srht = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("srht"))[1:]:
        name = re.search(r"(srht_fwd_reg|fwht_strided)_kernelI([df])Li(\d+)E"
                         r"(?:Lb([01])E)?", entry)
        if not name:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(regs and spill, "build: unreadable srht ptxas report")
        kind, dt, log2, batched = name.groups()
        form = {None: "", "0": ", one operator", "1": ", batched"}[batched]
        key = f"{kind}_kernel<{'double' if dt == 'd' else 'float'}, {log2}{form}>"
        srht[key] = {"registers": int(regs.group(1)),
                     "spill_stores": int(spill.group(1)),
                     "spill_loads": int(spill.group(2))}
        check(srht[key]["spill_stores"] == srht[key]["spill_loads"] == 0,
              f"build: {key} spills: {srht[key]}")
    # the flash backward's three kernels per dtype and head-dim width
    # (delta per dtype only): none may spill
    flash_bwd = {}
    for entry in re.split(r"Compiling entry function",
                          _build.build_log("flash_attention_bwd"))[1:]:
        name = re.search(r"flash_bwd_(delta|dkdv|dq)_kernelI(f|13__nv_bfloat16)"
                         r"(?:Li(\d+)E)?", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(name and regs and spill, "build: unreadable flash_bwd ptxas "
              "report")
        kind, dt, width = name.groups()
        key = (f"flash_bwd_{kind}_kernel<{'float' if dt == 'f' else 'bf16'}"
               + (f", {width}>" if width else ">"))
        flash_bwd[key] = {"registers": int(regs.group(1)),
                          "spill_stores": int(spill.group(1)),
                          "spill_loads": int(spill.group(2))}
        check(flash_bwd[key]["spill_stores"] == flash_bwd[key]["spill_loads"]
              == 0, f"build: {key} spills: {flash_bwd[key]}")
    check(len(flash_bwd) == 14, f"build: expected 14 flash_bwd kernel "
          f"instantiations, got {sorted(flash_bwd)}")
    log("[build] flash backward kernels, registers (no spills): " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(flash_bwd.items())))
    kinds = [key.split("_kernel")[0] for key in srht]
    check(kinds.count("srht_fwd_reg") == 36 and kinds.count("fwht_strided")
          == 28, f"build: expected 36 srht_fwd_reg and 28 fwht_strided "
          f"instantiations, got {sorted(srht)}")
    log("[build] srht register kernels, registers (no spills): " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(srht.items())))
    return {"seconds": total, "per_source": per_source,
            "flash_sm90_ptxas": ptxas, "flash_tf32x3_ptxas": tf32x3,
            "codec_ptxas": codec, "srht_ptxas": srht,
            "flash_bwd_ptxas": flash_bwd}


# ---------------------------------------------------------------------------
# 3. parity on the card
# ---------------------------------------------------------------------------

def _operator(gen, n, k, dtype, dev):
    signs = (2 * torch.randint(0, 2, (n,), generator=gen, device=dev)
             - 1).to(dtype)
    rows = torch.randperm(n, generator=gen, device=dev)[:k]
    return signs, rows


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_parity() -> dict:
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    cases = [  # (dim, n, k, batch)
        (64, 64, 32, (8, 500)), (64, 64, 32, (8,)), (64, 64, 32, (32,)),
        (64, 64, 32, ()),  # quickstart: A_j, gradients, S S^T, delta
        (18, 32, 10, (1000, 5000)), (18, 32, 10, (1000,)),
        (18, 32, 10, (10,)), (18, 32, 10, ()),  # the full-size shapes
        (100, 128, 7, (3, 7)), (1, 1, 1, (5,)), (5, 8, 3, (7, 9)),
        (10000, 16384, 50, (3,)),  # the largest transform
        # both sides of each route boundary (fwht.kernel_route), k = 1 and
        # k = n: the register transpose to n = 1024, fwht without shared
        # memory to n = 512, with one exchange from n = 1024 to 2^14
        (2, 2, 1, (5,)), (2, 2, 2, (5,)), (32, 32, 1, (33,)),
        (32, 32, 32, (33,)), (64, 64, 1, (9,)), (61, 64, 64, (9,)),
        (512, 512, 256, (5,)), (1000, 1024, 1, (3,)),
        (1024, 1024, 1024, (3,)), (2048, 2048, 100, (2,)),
        (16384, 16384, 1, (2,)), (16383, 16384, 16384, (2,)),
        # covtype's and phishing's main-path shapes (A_j, gradients, S^T I_k)
        (54, 64, 20, (200, 2906)), (54, 64, 20, (200,)), (54, 64, 20, (20,)),
        (68, 128, 17, (40, 277)), (68, 128, 17, (40,)), (68, 128, 17, (17,)),
        # dims just under n, and the far side of the single-pass limit
        (63, 64, 20, (65,)), (127, 128, 17, (33,)), (1023, 1024, 50, (5,)),
        (16383, 16384, 20, (3,)), (32768, 32768, 1, (2,)),
        # 2000 rows of n = 8192: more chunks than one wave of resident
        # blocks, so each block of the forward register kernel takes
        # several (its mbarrier's parity flips between them)
        (5000, 8192, 10, (2000,)),
    ]
    worst = {name: 0.0 for name in ("fwht", "srht_apply", "srht_apply_t")}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(1)
        for dim, n, k, batch in cases:
            signs, rows = _operator(gen, n, k, dtype, dev)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            xp = torch.randn(batch + (n,), generator=gen, dtype=dtype,
                             device=dev)
            pairs = {
                "srht_apply": (ops.srht_apply(x, signs, rows, impl="cuda"),
                               ops.srht_apply(x, signs, rows, impl="ref")),
                "srht_apply_t": (
                    ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                    ops.srht_apply_t(y, signs, rows, dim, impl="ref")),
                "fwht": (ops.fwht(xp, normalize=True, impl="cuda"),
                         ops.fwht(xp, normalize=True, impl="ref")),
            }
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k} batch={batch}: "
                      f"kernel differs from the plain version "
                      f"(max abs err {err:.3e})")
            del x, y, xp, pairs
    # srht_apply on views of x off a 16-byte boundary (the kernels read the
    # slab's aligned middle by a bulk copy, its ends value by value)
    views = [(54, 64, 20, (200, 37)), (68, 128, 17, (33,)),
             (1023, 1024, 50, (3,)), (16383, 16384, 20, (2,)),
             (18, 32, 10, (40,))]
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(3)
        per = 128 // torch.finfo(dtype).bits  # values of 16 bytes
        for dim, n, k, batch in views:
            signs, rows = _operator(gen, n, k, dtype, dev)
            count = math.prod(batch) * dim
            flat = torch.randn(count + per, generator=gen, dtype=dtype,
                               device=dev)
            for off in range(1, per):
                x = flat[off:off + count].view(batch + (dim,))
                check(x.data_ptr() % 16 != 0, "parity: view is aligned")
                got = ops.srht_apply(x, signs, rows, impl="cuda")
                want = ops.srht_apply(x, signs, rows, impl="ref")
                err = _max_err(got, want)
                worst["srht_apply"] = max(worst["srht_apply"], err)
                check(torch.equal(got, want),
                      f"srht_apply {dtype} dim={dim} n={n} k={k} batch="
                      f"{batch} view {off} values off a 16-byte boundary: "
                      f"kernel differs from the plain version (max abs "
                      f"err {err:.3e})")
    # signs other than +1 and -1 (standard normal, with some exactly +1,
    # -1 and -0.0) on every route of both SRHT forms: the forward register
    # kernel multiplies by the sign as read where it cannot use the bits
    signed = [(18, 32, 10, (40,)), (54, 64, 20, (300,)),
              (1023, 1024, 50, (9,)), (5000, 8192, 10, (700,)),
              (16383, 16384, 20, (3,)), (20000, 1 << 15, 64, (2,))]
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(7)
        for dim, n, k, batch in signed:
            _, rows = _operator(gen, n, k, dtype, dev)
            signs = torch.randn(n, generator=gen, dtype=dtype, device=dev)
            signs[:3] = torch.tensor([1.0, -1.0, -0.0], dtype=dtype)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            for name, got, want in (
                    ("srht_apply", ops.srht_apply(x, signs, rows, impl="cuda"),
                     ops.srht_apply(x, signs, rows, impl="ref")),
                    ("srht_apply_t",
                     ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                     ops.srht_apply_t(y, signs, rows, dim, impl="ref"))):
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k} batch={batch} "
                      f"with signs other than +-1: kernel differs from the "
                      f"plain version (max abs err {err:.3e})")
    # srht_apply with one operator per leading index (FedNS's per-client
    # sketches), on every forward route: each case with +-1 signs, with
    # signs other than +-1, and on a view of x off a 16-byte boundary
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(8)
        for g, inner, dim, n, k in BATCHED:
            x = torch.randn((g,) + inner + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            signs = (2 * torch.randint(0, 2, (g, n), generator=gen, device=dev)
                     - 1).to(dtype)
            rows = torch.stack([torch.randperm(n, generator=gen,
                                               device=dev)[:k]
                                for _ in range(g)])
            odd = torch.randn((g, n), generator=gen, dtype=dtype, device=dev)
            odd[:, :3] = torch.tensor([1.0, -1.0, -0.0], dtype=dtype)
            flat = torch.randn(x.numel() + 1, generator=gen, dtype=dtype,
                               device=dev)
            view = flat[1:].view(x.shape)
            check(view.data_ptr() % 16 != 0, "parity: view is aligned")
            for what, xx, ss in (("+-1 signs", x, signs),
                                 ("signs other than +-1", x, odd),
                                 ("a view off a 16-byte boundary", view, odd)):
                got = ops.srht_apply(xx, ss, rows, impl="cuda")
                want = ops.srht_apply(xx, ss, rows, impl="ref")
                err = _max_err(got, want)
                worst["srht_apply"] = max(worst["srht_apply"], err)
                check(torch.equal(got, want),
                      f"batched srht_apply {dtype} G={g} rows {inner} dim="
                      f"{dim} n={n} k={k} with {what}: kernel differs from "
                      f"the plain version (max abs err {err:.3e})")
    torch.cuda.synchronize()
    log(f"[parity] {len(cases)} shapes x 2 dtypes x 3 kernels, "
        f"{len(views)} misaligned srht_apply views x 2 dtypes, "
        f"{len(signed)} shapes with signs other than +-1 x 2 dtypes x 2 "
        f"kernels and {len(BATCHED)} batched srht_apply shapes x 3 inputs x "
        f"2 dtypes bit-equal to the plain versions (max abs err {worst})")
    return worst


# ---------------------------------------------------------------------------
# 4. quickstart
# ---------------------------------------------------------------------------

def _flens_run(problem, w0, w_star, rounds, *, impl=None, **kw):
    from repro_torch.core import FLeNS, run_rounds
    from repro_torch.kernels import ops

    with ops.use_impl(impl):
        opt = FLeNS(**kw)
        return opt, run_rounds(opt, problem, w0, w_star, rounds=rounds)


def _check_trajectory(hist, label: str) -> None:
    check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
          f"{label}: non-finite loss")
    check(bool((hist.loss[1:] <= hist.loss[:-1]).all()),
          f"{label}: the guarded loss rose")
    check(hist.gap[-1] < 0.1 * hist.gap[0],
          f"{label}: gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e} did not "
          f"fall tenfold")


def phase_quickstart() -> dict:
    from repro_torch.core import logistic, make_problem, newton_solve
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    X, y = make_classification(0, n=QUICK["n"], dim=QUICK["dim"], device=dev)
    problem = make_problem(X, y, m=QUICK["m"], lam=QUICK["lam"],
                           objective=logistic, device=dev)
    w0 = torch.zeros(QUICK["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    rounds = 12
    ops.reset_launch_counts()
    _, hist = _flens_run(problem, w0, w_star, rounds, k=QUICK["k"])
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_CODEC, **NO_LM}
    check(counts == want, f"quickstart launches {counts} != {want}")
    _check_trajectory(hist, "quickstart")
    _, plain = _flens_run(problem, w0, w_star, rounds, impl="ref",
                          k=QUICK["k"])
    check((hist.loss == plain.loss).all(),
          f"quickstart through the kernels {hist.loss.tolist()} != through "
          f"the plain versions {plain.loss.tolist()}")
    ops.reset_launch_counts()
    _, plus = _flens_run(problem, w0, w_star, rounds, k=QUICK["k"],
                         variant="plus")
    counts_plus = ops.launch_counts()
    check(counts_plus == {"fwht": 0, "srht_apply": 4 * rounds,
                          "srht_apply_t": 3 * rounds, **NO_CODEC, **NO_LM},
          f"FLeNS+ launches {counts_plus}")
    _check_trajectory(plus, "quickstart FLeNS+")
    log("[quickstart] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[quickstart] launches {counts} (FLeNS+ {counts_plus}); "
        f"trajectory equal to the plain versions' on the card")
    return {"gap": hist.gap.tolist(), "launches": counts,
            "launches_plus": counts_plus, "gap_plus": plus.gap.tolist(),
            "bytes_per_round": float(hist.cumulative_bytes[1])}


# ---------------------------------------------------------------------------
# 5. full size
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
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


def _bound_ms(read: int, written: int, ops_count: float, dtype,
              peak: float = None) -> tuple:
    t_bytes = (read + written) / MEM_BYTES_PER_S
    t_ops = ops_count / (peak or PEAK_OPS_PER_S[dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


HOST_REPS = 10_000


def _host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds per call of fn over reps back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def _host_path(y, signs, rows, dim, dense) -> dict:
    """Host microseconds per call of each step of the launch path of
    ``ops.srht_apply_t(..., impl="cuda")``, each step timed alone; beside
    them the same steps as the parent commit took them, and the host time
    of the library call."""
    import ctypes

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fwht as kfwht
    from repro_torch.kernels import srht as ksrht

    n, k = signs.shape[0], rows.shape[0]
    suffix = kfwht.check_input(y, "y")
    norm, scale = ksrht._factors(n, k, y.dtype)
    entry = ksrht._entry("srht_apply_t", suffix, False)
    out = y.new_empty(y.shape[:-1] + (dim,))
    nrows = y.numel() // k
    args = (y.data_ptr(), signs.data_ptr(), rows.data_ptr(), out.data_ptr(),
            nrows, dim, n, k, norm, scale, kfwht.stream_of(y))
    lib = _build.library()
    p, i = ctypes.c_void_p, ctypes.c_int
    by_ctypes = ctypes.CFUNCTYPE(
        ctypes.c_int, p, p, p, p, ctypes.c_longlong, i, i, i, ctypes.c_double,
        ctypes.c_double, p)((f"repro_srht_apply_t_{suffix}", lib))

    def guard():
        with kfwht.device_guard(y):
            pass

    def parent_guard():
        with torch.cuda.device(y.device):
            pass
    path = {
        "dispatch (resolve_impl, get_impl)":
            lambda: ops.get_impl("srht_apply_t", ops.resolve_impl("cuda", y), y),
        "checks (check_input, _check_operator)":
            lambda: (kfwht.check_input(y, "y"),
                     ksrht._check_operator(y, signs, rows, dim)),
        "output (new_empty)": lambda: y.new_empty(out.shape),
        "factors (_factors)": lambda: ksrht._factors(n, k, y.dtype),
        "entry point (_entry)":
            lambda: ksrht._entry("srht_apply_t", suffix, False),
        "device guard (device_guard)": guard,
        "stream (stream_of)": lambda: kfwht.stream_of(y),
        "launch (extension call)": lambda: entry(*args),
    }
    parent = {
        "capability (get_device_capability)":
            lambda: torch.cuda.get_device_capability(y.device),
        "operator checks by torch.device":
            lambda: (signs.dtype != y.dtype or signs.device != y.device,
                     rows.dtype != torch.int64 or rows.device != y.device),
        "output (torch.empty(device=))":
            lambda: torch.empty(out.shape, dtype=y.dtype, device=y.device),
        "device guard (torch.cuda.device)": parent_guard,
        "stream (current_stream().cuda_stream)":
            lambda: torch.cuda.current_stream(y.device).cuda_stream,
        "entry point (f-string getattr)":
            lambda: getattr(lib, f"repro_srht_apply_t_{suffix}"),
        "launch (ctypes call)": lambda: by_ctypes(*args),
    }
    steps = {name: _host_us(fn) for name, fn in path.items()}
    return {"steps_us": steps, "steps_sum_us": sum(steps.values()),
            "call_us": _host_us(lambda: ops.srht_apply_t(y, signs, rows, dim,
                                                         impl="cuda")),
            "parent_steps_us": {name: _host_us(fn)
                                for name, fn in parent.items()},
            "library_call_us": _host_us(lambda: torch.matmul(y, dense)),
            "reps": HOST_REPS}


def _srht_fwd_row(label, x, signs, rows, dense) -> dict:
    """srht_apply through the kernel at one shape: events and the
    profiler's device time, the bound, the plain version and the library
    yardstick x @ S.T (``dense`` is S, (k, dim); None where S is too large
    to hold)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import kernel_route

    n, k = signs.shape[0], rows.shape[0]
    item = x.element_size()
    rows_n = x.numel() // x.shape[-1]
    reps = 20 if x.numel() > 1_000_000 else 200

    def kern():
        return ops.srht_apply(x, signs, rows, impl="cuda")

    def plain():
        return ops.srht_apply(x, signs, rows, impl="ref")

    def lib():
        return torch.matmul(x, dense.T)
    # x, signs and rows read once, the outputs written once; per row n
    # log2(n) adds, n sign flips, and x norm x scale on the k kept
    bound, bound_by = _bound_ms(
        x.numel() * item + n * item + k * 8, rows_n * k * item,
        rows_n * (n * int(math.log2(n)) + n + 2 * k), x.dtype)
    got, want = kern(), plain()
    check(torch.equal(got, want), f"srht_apply {label}: kernel differs from "
          f"the plain version (max abs err {_max_err(got, want):.3e})")
    by_kernel = _device_kernels_ms(kern, reps)
    return dict(shape=label, dims=list(x.shape), n=n, k=k,
                route=kernel_route("srht_apply", n), ms=_time_ms(kern, reps),
                device_ms=sum(by_kernel.values()), device_kernels_ms=by_kernel,
                plain_ms=_time_ms(plain, max(reps // 4, 5)),
                library_ms=None if dense is None else _time_ms(lib, reps),
                library_device_ms=None if dense is None else _device_ms(lib, reps),
                bound_ms=bound, bound_by=bound_by,
                max_abs_err=_max_err(got, want))


def _kernel_timings(s, a, gs) -> dict:
    """Each kernel at its main-path shapes, beside its bound, the plain
    version and one PyTorch call computing the same function, with the
    profiler's device time and the kernel that serves the shape; for
    srht_apply_t also the host path step by step."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.fwht import kernel_route

    dtype, dev = a.dtype, a.device
    item = a.element_size()
    n, k, dim = s.signs.shape[0], s.k, s.dim
    dense = s.dense()  # (k, dim), the library yardstick's operator
    eye_k = torch.eye(k, dtype=dtype, device=dev)
    delta = torch.randn(k, dtype=dtype, device=dev)
    # the quickstart's operator (dim 64 -> k 32, n 64) and its S^T calls
    gen = torch.Generator(device=dev).manual_seed(5)
    q_signs, q_rows = _operator(gen, 64, QUICK["k"], dtype, dev)
    q_dense = kref.srht_apply_t(torch.eye(QUICK["k"], dtype=dtype, device=dev),
                                q_signs, q_rows, QUICK["dim"])
    q_eye = torch.eye(QUICK["k"], dtype=dtype, device=dev)
    q_delta = torch.randn(QUICK["k"], dtype=dtype, device=dev)
    susy = (s.signs, s.rows, dim, dense)
    quick = (q_signs, q_rows, QUICK["dim"], q_dense)
    calls = {  # kernel -> its main-path inputs and operator
        "srht_apply": [
            ("A_j (m, n_shard, M)", a, susy),
            ("gradients (m, M)", gs, susy),
            ("S^T I_k (k, M)", s.apply_t(eye_k), susy),
        ],
        "srht_apply_t": [
            ("I_k (k, k)", eye_k, susy),
            ("delta_k (k,)", delta, susy),
            ("quickstart I_k (32, 32)", q_eye, quick),
            ("quickstart delta_k (32,)", q_delta, quick),
        ],
    }
    out = {"srht_apply": [_srht_fwd_row(label, x, signs, rows, op)
                          for label, x, (signs, rows, _, op)
                          in calls.pop("srht_apply")]}
    for name, shapes in calls.items():
        rows_out = []
        for label, x, (signs, rows, d, op) in shapes:
            n_op, k_op = signs.shape[0], rows.shape[0]
            log_n = int(math.log2(n_op))
            op_bytes = n_op * item + k_op * 8  # signs + rows, read once
            rows_n = x.numel() // x.shape[-1]

            def kern(x=x, signs=signs, rows=rows, d=d):
                return ops.srht_apply_t(x, signs, rows, d, impl="cuda")

            def plain(x=x, signs=signs, rows=rows, d=d):
                return ops.srht_apply_t(x, signs, rows, d, impl="ref")

            def lib(x=x, op=op):
                return torch.matmul(x, op)
            read, written = x.numel() * item, rows_n * d * item
            count = rows_n * (n_op * log_n + k_op + 2 * d)
            reps = 20 if x.numel() > 1_000_000 else 200
            bound, bound_by = _bound_ms(read + op_bytes, written, count, dtype)
            row = dict(
                shape=label, dims=list(x.shape), n=n_op,
                route=kernel_route(name, n_op), ms=_time_ms(kern, reps),
                plain_ms=_time_ms(plain, max(reps // 4, 5)),
                library_ms=_time_ms(lib, reps), bound_ms=bound,
                bound_by=bound_by,
                max_abs_err=_max_err(kern(), plain()))
            check(row["max_abs_err"] == 0.0, f"{name} {label}: kernel "
                  f"differs from the plain version (max abs err "
                  f"{row['max_abs_err']:.3e})")
            row.update(device_ms=_device_ms(kern, reps),
                       library_device_ms=_device_ms(lib, reps),
                       host_path=_host_path(x, signs, rows, d, op))
            rows_out.append(row)
        out[name] = rows_out
    # fwht is off the main path; it is timed at the padded rows of the
    # path's largest call, (m * n_shard, n), and at the single-pass limit
    out["fwht"] = []
    for label, shape, reps in (
            ("padded rows of A_j (m * n_shard, n)", (a.numel() // dim, n), 20),
            ("(64, 2^14), the single-pass limit", (64, 1 << 14), 200)):
        xp = torch.randn(shape, dtype=dtype, device=dev)
        had = kref.hadamard_matrix(shape[1], dtype, dev)
        log_x = int(math.log2(shape[1]))
        bound, bound_by = _bound_ms(xp.numel() * item, xp.numel() * item,
                                    shape[0] * (shape[1] * log_x + shape[1]),
                                    dtype)

        def kern(xp=xp):
            return ops.fwht(xp, normalize=True, impl="cuda")

        def lib(xp=xp, had=had):
            return torch.matmul(xp, had)
        out["fwht"].append(dict(
            shape=label, dims=list(xp.shape), n=shape[1],
            route=kernel_route("fwht", shape[1]), ms=_time_ms(kern, reps),
            device_ms=_device_ms(kern, reps),
            plain_ms=_time_ms(lambda xp=xp: ops.fwht(xp, normalize=True,
                                                     impl="ref"), 5),
            library_ms=_time_ms(lib, reps),
            library_device_ms=_device_ms(lib, reps),
            bound_ms=bound, bound_by=bound_by,
            max_abs_err=_max_err(kern(), ops.fwht(xp, normalize=True,
                                                  impl="ref"))))
        check(out["fwht"][-1]["max_abs_err"] == 0.0, f"fwht {label}: kernel "
              f"differs from the plain version (max abs err "
              f"{out['fwht'][-1]['max_abs_err']:.3e})")
        del xp, had
    return out


def _profile_rounds(opt, problem, state, keys) -> dict:
    """Device time by kernel over a few bare rounds (torch.profiler), and
    the device's busy share of the window's wall time."""
    keys = iter(keys)

    def step():
        nonlocal state
        state = opt.round(problem, state, next(keys))
    return _profile_steps(step, 3)


def _profile_steps(step, rounds: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_us = sum(t for _, t, _ in kernels)
    return {"rounds": rounds, "wall_us": wall_us, "device_busy_us": busy_us,
            "busy_share": busy_us / wall_us,
            "top": [{"kernel": name[:90], "us_per_round": t / rounds,
                     "launches_per_round": c / rounds}
                    for name, t, c in kernels[:12]]}


def phase_full_size() -> "tuple[dict, tuple]":
    """Returns the record and the (problem, w0, w_star) the transport
    phase runs on."""
    from repro_torch.core import (
        FLeNS,
        logistic,
        make_problem,
        newton_solve,
        run_rounds,
    )
    from repro_torch.core.base import root_key, split
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y = make_classification(
        1, n=SUSY["n"], dim=SUSY["dim"], spectrum_decay=SUSY["spectrum_decay"],
        label_noise=SUSY["label_noise"], device=dev)
    problem = make_problem(X, y, m=SUSY["m"], lam=SUSY["lam"],
                           objective=logistic, device=dev)
    del X, y
    w0 = torch.zeros(SUSY["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grad_star = float(torch.linalg.vector_norm(problem.global_grad(w_star)))
    check(grad_star < 1e-10, f"newton_solve gradient norm {grad_star:.3e}")

    rounds = 10
    ops.reset_launch_counts()
    opt = FLeNS(k=SUSY["k"])
    hist = run_rounds(opt, problem, w0, w_star, rounds=rounds)
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_CODEC, **NO_LM}
    check(counts == want, f"full-size launches {counts} != {want}")
    _check_trajectory(hist, "full size")

    # bare rounds, host clock around work that ends in a synchronize
    state = opt.init(problem, w0)
    keys = split(root_key(7, device=dev), rounds + 1)
    state = opt.round(problem, state, keys[0])  # warm
    torch.cuda.synchronize()
    round_ms = []
    for t in range(rounds):
        t1 = time.perf_counter()
        state = opt.round(problem, state, keys[t + 1])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_rounds(opt, problem, state,
                              split(root_key(8, device=dev), 3))

    s = opt.policy.materialize(keys[0], problem.dim, dtype=torch.float64,
                               device=dev)
    a = problem.local_hess_sqrt(state["w"])
    gs = problem.local_grad(state["w"])
    timings = _kernel_timings(s, a, gs)
    log("[full] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[full] setup {setup_s:.2f} s; run_rounds {hist.wall_time_s * 1e3 / rounds:.2f} "
        f"ms/round with per-round eval; bare rounds "
        f"{sorted(round_ms)[len(round_ms) // 2]:.2f} ms median "
        f"({min(round_ms):.2f}..{max(round_ms):.2f}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    log(f"[full] profile: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / profile['rounds'] / 1e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[full]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for name, rows in timings.items():
        for r in rows:
            device = (f", device {r['device_ms']:.4f} (library "
                      f"{r['library_device_ms']:.4f})" if "device_ms" in r
                      else "")
            log(f"[full] {name:<12} {r['shape']:<38} {r['ms']:.4f} ms"
                f"{device} (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}); "
                f"{r['route']}")
            if "host_path" in r:
                hp = r["host_path"]
                log(f"[full]   host path, us per call over {hp['reps']}: "
                    f"whole call {hp['call_us']:.2f}, steps "
                    f"{hp['steps_sum_us']:.2f} in all, library call "
                    f"{hp['library_call_us']:.2f}")
                for step, us in hp["steps_us"].items():
                    log(f"[full]     {step:<40} {us:7.2f}")
                for step, us in hp["parent_steps_us"].items():
                    log(f"[full]     parent: {step:<32} {us:7.2f}")
    return ({"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
             "launches": counts, "rounds": rounds,
             "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
             "round_ms": round_ms, "setup_s": setup_s,
             "peak_memory_bytes": peak, "profile": profile,
             "bytes_per_round":
             float(hist.cumulative_bytes[1]), "kernels": timings},
            (problem, w0, w_star))


# ---------------------------------------------------------------------------
# 5b. covtype at full size
# ---------------------------------------------------------------------------

def phase_covtype() -> dict:
    """FLeNS on the covtype twin at the real row count, through the
    forward SRHT's register route (n = 64); then srht_apply at the
    main-path shapes of covtype, phishing and the quickstart and at one
    FedNS-like call."""
    from repro_torch.core import logistic, make_problem, newton_solve
    from repro_torch.core.base import root_key, split
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    dev = torch.device("cuda", 0)
    dim, k = COVTYPE["dim"], COVTYPE["k"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y = make_classification(
        3, n=COVTYPE["n"], dim=dim, spectrum_decay=COVTYPE["spectrum_decay"],
        label_noise=COVTYPE["label_noise"], device=dev)
    problem = make_problem(X, y, m=COVTYPE["m"], lam=COVTYPE["lam"],
                           objective=logistic, device=dev)
    del X, y
    w0 = torch.zeros(dim, dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grad_star = float(torch.linalg.vector_norm(problem.global_grad(w_star)))
    check(grad_star < 1e-10, f"covtype newton_solve gradient norm {grad_star:.3e}")

    rounds = 10
    ops.reset_launch_counts()
    opt, hist = _flens_run(problem, w0, w_star, rounds, k=k)
    counts = ops.launch_counts()
    want = {"fwht": 0, "srht_apply": 3 * rounds, "srht_apply_t": 2 * rounds,
            **NO_CODEC, **NO_LM}
    check(counts == want, f"covtype launches {counts} != {want}")
    _check_trajectory(hist, "covtype")
    _, plain = _flens_run(problem, w0, w_star, rounds, impl="ref", k=k)
    check((hist.loss == plain.loss).all(),
          f"covtype through the kernels {hist.loss.tolist()} != through the "
          f"plain versions {plain.loss.tolist()}")

    # bare rounds, host clock around work that ends in a synchronize
    state = opt.init(problem, w0)
    keys = split(root_key(7, device=dev), rounds + 1)
    state = opt.round(problem, state, keys[0])  # warm
    torch.cuda.synchronize()
    round_ms = []
    for t in range(rounds):
        t1 = time.perf_counter()
        state = opt.round(problem, state, keys[t + 1])
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_rounds(opt, problem, state,
                              split(root_key(8, device=dev), 3))

    s = opt.policy.materialize(keys[0], dim, dtype=torch.float64, device=dev)
    dense = s.dense()
    calls = [("covtype A_j (m, n_shard, M)", problem.local_hess_sqrt(state["w"]),
              s.signs, s.rows, dense),
             ("covtype gradients (m, M)", problem.local_grad(state["w"]),
              s.signs, s.rows, dense),
             ("covtype S^T I_k (k, M)",
              s.apply_t(torch.eye(k, dtype=torch.float64, device=dev)),
              s.signs, s.rows, dense)]
    del problem, state
    # phishing (n_shard = 277 of 11,055 rows over 40 clients), the
    # quickstart, and FedNS's data-axis sketch at the SUSY size (1000
    # clients x 18 features, 5000 rows a shard) with one shared operator
    gen = torch.Generator(device=dev).manual_seed(6)
    n_shard = -(-PHISHING["n"] // PHISHING["m"])
    for label, shape, n, kk in (
            ("phishing A_j (m, n_shard, M)", (PHISHING["m"], n_shard, 68), 128, 17),
            ("phishing gradients (m, M)", (PHISHING["m"], 68), 128, 17),
            ("phishing S^T I_k (k, M)", (17, 68), 128, 17),
            ("quickstart A_j (m, n_shard, M)", (8, 500, 64), 64, QUICK["k"]),
            ("FedNS data axis (m * M, n_shard), one operator", (18000, 5000),
             8192, 10)):
        signs, rows = _operator(gen, n, kk, torch.float64, dev)
        x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        eye = torch.eye(shape[-1], dtype=torch.float64, device=dev)
        calls.append((label, x, signs, rows, kref.srht_apply(eye, signs, rows).T))
        del eye
    timings = []
    for label, x, signs, rows, op in calls:
        timings.append(_srht_fwd_row(label, x, signs, rows, op))
    del calls
    log("[covtype] gap " + " ".join(f"{g:.3e}" for g in hist.gap))
    log(f"[covtype] setup {setup_s:.2f} s; run_rounds "
        f"{hist.wall_time_s * 1e3 / rounds:.2f} ms/round with per-round eval; "
        f"bare rounds {sorted(round_ms)[len(round_ms) // 2]:.2f} ms median "
        f"({min(round_ms):.2f}..{max(round_ms):.2f}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}; trajectory equal to the "
        f"plain versions' on the card")
    log(f"[covtype] profile: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / profile['rounds'] / 1e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[covtype]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for r in timings:
        log(f"[covtype] srht_apply {r['shape']:<46} {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, x @ S.T "
            f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f}); "
            f"{r['route']}")
    return {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
            "launches": counts, "rounds": rounds,
            "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
            "round_ms": round_ms, "setup_s": setup_s,
            "peak_memory_bytes": peak, "profile": profile,
            "srht_apply": timings}


# ---------------------------------------------------------------------------
# 5c. the other Table-I optimizers at full size
# ---------------------------------------------------------------------------

def _dense_operators(signs: torch.Tensor, rows: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """The m SRHT operators as dense (m, k, dim) matrices, the library
    yardstick's operands: S_j[c, i] = signs_j[i] (-1)^popcount(rows_j[c]
    & i) / sqrt(k)."""
    k = rows.shape[1]
    both = rows[:, :, None] & torch.arange(dim, device=rows.device)
    parity = torch.zeros_like(both)
    for b in range(int(signs.shape[1]).bit_length()):
        parity ^= (both >> b) & 1
    return ((1 - 2 * parity).to(signs.dtype) * signs[:, None, :dim]
            / math.sqrt(k))


def _srht_batched_row(label, a, k, seed) -> dict:
    """FedNS's call: srht_apply with one operator per client on the
    contiguous transpose of A (m, n_shard, M), one launch. Events and the
    profiler's device time by kernel, the transpose copy on its own, the
    bound, the plain version and torch.bmm of the dense per-client S_j
    with A_j (the build not timed)."""
    from repro_torch.core.sketch import make_sketches
    from repro_torch.keys import key_from_ints
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import kernel_route

    m, n_shard, dim_f = a.shape
    s = make_sketches(key_from_ints(seed), "srht", m, k, n_shard,
                      dtype=a.dtype, device=a.device)
    n = s.signs.shape[1]
    at = a.transpose(1, 2).contiguous()
    dense = _dense_operators(s.signs, s.rows, n_shard)
    item = a.element_size()
    reps = 20 if a.numel() > 1_000_000 else 200

    def copy():
        return a.transpose(1, 2).contiguous()

    def kern():
        return ops.srht_apply(at, s.signs, s.rows, impl="cuda")

    def plain():
        return ops.srht_apply(at, s.signs, s.rows, impl="ref")

    def lib():
        return torch.bmm(dense, a)
    before = ops.launch_counts()["srht_apply"]
    got = kern()
    check(ops.launch_counts()["srht_apply"] == before + 1,
          f"batched srht_apply {label}: not one launch")
    want = plain()
    check(torch.equal(got, want), f"batched srht_apply {label}: kernel "
          f"differs from the plain version (max abs err "
          f"{_max_err(got, want):.3e})")
    lib_err = _max_err(got.transpose(1, 2), lib())
    check(lib_err < 1e-9 * float(got.abs().max()),
          f"batched srht_apply {label}: bmm yardstick off by {lib_err:.3e}")
    rows_n = m * dim_f
    # x, the m operators' signs and rows read once, the outputs written
    # once; per row n log2(n) adds, n sign flips, x norm x scale on k
    bound, bound_by = _bound_ms(at.numel() * item + m * n * item + m * k * 8,
                                rows_n * k * item,
                                rows_n * (n * int(math.log2(n)) + n + 2 * k),
                                a.dtype)
    by_kernel = _device_kernels_ms(kern, reps)
    row = dict(shape=label, dims=list(at.shape), operators=m, n=n, k=k,
               route=kernel_route("srht_apply", n) + ", one operator a client",
               ms=_time_ms(kern, reps), device_ms=sum(by_kernel.values()),
               device_kernels_ms=by_kernel,
               transpose_ms=_time_ms(copy, reps),
               transpose_device_ms=_device_ms(copy, reps),
               plain_ms=_time_ms(plain, max(reps // 4, 5)),
               library="torch.bmm(S (m, k, n_shard), A (m, n_shard, M))",
               library_ms=_time_ms(lib, reps),
               library_device_ms=_device_ms(lib, reps),
               library_max_abs_err=lib_err, bound_ms=bound, bound_by=bound_by,
               max_abs_err=_max_err(got, want))
    del at, dense, got, want
    return row


def _fedns_transport(rounds: int = 12) -> dict:
    """FedNS with a fixed basis (EF-eligible) at the quickstart size under
    one CommConfig on the edge channel: the kernels' trajectory, bytes and
    traces equal to the plain versions'; launches as the round implies."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FedNS, logistic, make_problem, newton_solve
    from repro_torch.core import run_rounds
    from repro_torch.data import make_classification
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    X, y = make_classification(0, n=QUICK["n"], dim=QUICK["dim"], device=dev)
    problem = make_problem(X, y, m=QUICK["m"], lam=QUICK["lam"],
                           objective=logistic, device=dev)
    w0 = torch.zeros(QUICK["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(problem, w0)
    # every client scheduled (a half cohort's Hessian diverges here at
    # mu = 1); the edge channel still drops 10%
    cfg = CommConfig(codecs={"sa": "qint8", "grad": "topk0.5+qint8"},
                     channel=_edge_channel(QUICK["m"]), scheduler="full",
                     error_feedback=True, seed=1)
    runs = {}
    for impl in (None, "ref"):
        ops.reset_launch_counts()
        with ops.use_impl(impl):
            # a basis held across rounds needs k = M here to converge
            runs[impl] = run_rounds(FedNS(k=QUICK["dim"], sketch="srht:fixed"),
                                    problem, w0, w_star, rounds=rounds,
                                    comm=cfg)
        if impl is None:
            counts = ops.launch_counts()
    hist, plain = runs[None], runs["ref"]
    per_round = _codec_launches_per_round(cfg, ("grad", "sa"))
    want = {"fwht": 0, "srht_apply": rounds, "srht_apply_t": 0, **NO_LM,
            **{op: c * rounds for op, c in per_round.items()}}
    check(counts == want, f"FedNS under transport launches {counts} != {want}")
    check((hist.loss == plain.loss).all(),
          f"FedNS under transport: kernels {hist.loss.tolist()} != plain "
          f"{plain.loss.tolist()}")
    check((hist.cumulative_bytes == plain.cumulative_bytes).all()
          and [t.to_dict() for t in hist.traces]
          == [t.to_dict() for t in plain.traces],
          "FedNS under transport: bytes or traces differ from the plain run")
    check(set(hist.ef_residuals) == {"sa", "grad"},
          f"FedNS srht:fixed EF payloads {sorted(hist.ef_residuals)}")
    check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all())
          and hist.gap[-1] < hist.gap[0],
          f"FedNS under transport: gap {hist.gap.tolist()}")
    log(f"[table-I] FedNS srht:fixed, k 64, at the quickstart size under "
        f"{{sa: qint8, grad: topk0.5+qint8}}, full cohort, EF: gap "
        + " ".join(f"{g:.2e}" for g in hist.gap[::3])
        + f"; {hist.cumulative_bytes[-1]:.0f} bytes, launches {counts}; "
        f"trajectory, bytes and traces equal to the plain versions'")
    return {"gap": hist.gap.tolist(), "launches": counts,
            "cumulative_bytes": hist.cumulative_bytes.tolist(),
            "ef_residuals": hist.ef_residuals}


def phase_table_one(problem, w0, w_star) -> dict:
    """The nine other Table-I optimizers on the SUSY problem at full size,
    10 rounds each with comm=None; FedNS and FedNDES one batched
    srht_apply launch a round and their trajectories equal to the plain
    versions' on the card; then the batched srht_apply timed at the three
    FedNS shapes, and FedNS under a transport at the quickstart size."""
    from repro_torch.core import make_optimizer, run_rounds
    from repro_torch.core.base import root_key, split
    from repro_torch.kernels import ops

    dev = problem.X.device
    rounds = 10
    out = {}
    for name, kw in TABLE_ONE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        opt = make_optimizer(name, **kw)
        hist = run_rounds(opt, problem, w0, w_star, rounds=rounds)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"fwht": 0, "srht_apply": rounds if name in SKETCHED else 0,
                "srht_apply_t": 0, **NO_CODEC, **NO_LM}
        check(counts == want, f"{name} launches {counts} != {want}")
        check(bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
              f"{name}: non-finite loss {hist.loss.tolist()}")
        check(hist.gap[-1] < hist.gap[0],
              f"{name}: gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e} did not fall")
        if name in SKETCHED:
            with ops.use_impl("ref"):
                plain = run_rounds(make_optimizer(name, **kw), problem, w0,
                                   w_star, rounds=rounds)
            check((hist.loss == plain.loss).all(),
                  f"{name} through the kernel {hist.loss.tolist()} != through "
                  f"the plain version {plain.loss.tolist()}")
        state = opt.init(problem, w0)
        keys = iter(split(root_key(7, device=dev), rounds + 1))

        def step():
            nonlocal state
            state = opt.round(problem, state, next(keys))
        bare = _bare_ms(step, rounds)
        row = {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
               "launches": counts, "uplink_floats": hist.uplink_floats,
               "run_rounds_ms_per_round": hist.wall_time_s * 1e3 / rounds,
               "round_ms": bare, "peak_memory_bytes": peak}
        if name in SKETCHED:
            row["k"] = opt.k
            row["profile"] = _profile_rounds(opt, problem, state,
                                             split(root_key(8, device=dev), 3))
        out[name] = row
        log(f"[table-I] {name:<18} gap " + " ".join(f"{g:.2e}" for g in hist.gap))
        log(f"[table-I] {name:<18} run_rounds "
            f"{row['run_rounds_ms_per_round']:.2f} ms/round with per-round "
            f"eval; bare rounds {sorted(bare)[len(bare) // 2]:.2f} ms median "
            f"({min(bare):.2f}..{max(bare):.2f}); peak memory "
            f"{peak / 2**30:.2f} GiB; uplink {hist.uplink_floats} floats"
            + (f"; k {opt.k}; srht_apply launches {counts['srht_apply']}, "
               f"trajectory equal to the plain version's"
               if name in SKETCHED else ""))
        if name in SKETCHED:
            prof = row["profile"]
            log(f"[table-I]   profile: device busy {prof['busy_share']:.1%} "
                f"of {prof['wall_us'] / prof['rounds'] / 1e3:.2f} ms/round")
            for r in prof["top"][:8]:
                log(f"[table-I]   {r['us_per_round']:9.1f} us/round x"
                    f"{r['launches_per_round']:.0f}  {r['kernel']}")
    # the batched srht_apply at the three FedNS shapes: SUSY's A_j (at
    # w*), covtype's and the quickstart's (random A of their shapes)
    gen = torch.Generator(device=dev).manual_seed(12)
    timings = [_srht_batched_row("SUSY A_j (1000, 5000, 18) -> n 8192, k 10",
                                 problem.local_hess_sqrt(w_star), SUSY["k"], 1)]
    for label, shape, k in (
            ("covtype A_j (200, 2906, 54) -> n 4096, k 20", (200, 2906, 54),
             COVTYPE["k"]),
            ("quickstart A_j (8, 500, 64) -> n 512, k 32", (8, 500, 64),
             QUICK["k"])):
        a = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        timings.append(_srht_batched_row(label, a, k, 2))
        del a
    for r in timings:
        log(f"[table-I] batched srht_apply {r['shape']}: {r['ms']:.4f} ms, "
            f"device {r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, bmm "
            f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f}); "
            f"{r['route']}")
        log(f"[table-I]   transpose copy A -> (m, M, n_shard) alone: "
            f"{r['transpose_ms']:.4f} ms, device {r['transpose_device_ms']:.4f}")
        for name, ms in r["device_kernels_ms"].items():
            log(f"[table-I]   {ms:.4f} ms  {name}")
    return {"optimizers": out, "srht_apply_batched": timings,
            "fedns_transport": _fedns_transport()}


# ---------------------------------------------------------------------------
# 5d. the asynchronous driver at SUSY's full size
# ---------------------------------------------------------------------------

# benchmarks/paper_common.py:16-31, straggler_edge_channel: log-spaced
# uplinks 3e4-3e6 B/s, 10x downlinks, 50 ms latency, 30% stragglers at
# 10x, no dropout (the full-quorum anchor stays on the lock-step path)
STRAGGLER = dict(lo=3e4, hi=3e6, down=10.0, latency_s=0.05,
                 straggler_prob=0.30, straggler_slowdown=10.0)
# examples/edge_clients.py:94-105, population_edge_channel: per-id links
POP_EDGE = dict(uplink_bytes_per_s="loguniform:3e4,3e6",
                downlink_bytes_per_s="loguniform:3e5,3e7", latency_s=0.08,
                straggler_prob=0.20, straggler_slowdown=10.0,
                dropout_prob=0.10)
FLENS_PLUS_UPLINKS = ("h_sk", "sg", "grad", "loss")
# the event loop's host work: these session methods, timed apart from
# the rounds (the device work) they surround
EVENT_METHODS = ("begin_round", "end_round", "_pump", "_dispatch_cohort",
                 "_record_trace",
                 "_gc_snapshots", "_groups", "_combine", "_mask")


def _card() -> torch.device:
    return torch.device("cuda", 0)


def _straggler_channel(m: int):
    from repro_torch.comm import ChannelModel

    c = STRAGGLER
    rates = torch.logspace(math.log10(c["lo"]), math.log10(c["hi"]), m,
                           dtype=torch.float64).numpy()
    return ChannelModel(uplink_bytes_per_s=rates,
                        downlink_bytes_per_s=c["down"] * rates,
                        latency_s=c["latency_s"],
                        straggler_prob=c["straggler_prob"],
                        straggler_slowdown=c["straggler_slowdown"])


def _groups_per_commit(hist) -> list:
    """Distinct base versions among each commit's arrivals."""
    return [len(np.unique(tr.staleness[~np.isnan(tr.staleness)]))
            for tr in hist.traces]


def _expected_launches(cfg, executed: int) -> dict:
    """FLeNS+ launches 4 srht_apply and 3 srht_apply_t a round, and each
    codec stage one kernel a round."""
    per_round = _codec_launches_per_round(cfg, FLENS_PLUS_UPLINKS)
    return {"fwht": 0, "srht_apply": 4 * executed,
            "srht_apply_t": 3 * executed, **NO_LM,
            **{op: n * executed for op, n in per_round.items()}}


def _timed_events(session) -> dict:
    """Wrap the session's event-loop methods with host timers (an outer
    call's time includes the calls it makes, counted once)."""
    acc = {"s": 0.0, "depth": 0}
    for name in EVENT_METHODS:
        fn = getattr(session, name, None)
        if fn is None:
            continue

        def timed(*a, _fn=fn, **k):
            acc["depth"] += 1
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc["depth"] -= 1
                if acc["depth"] == 0:
                    acc["s"] += time.perf_counter() - t0
        setattr(session, name, timed)
    return acc


def _bare_commits(opt, problem, w0, cfg, commits: int,
                  population=None, profiled: bool = True) -> dict:
    """Drive ``commits`` steps of the session ``cfg`` selects, each ended
    by a synchronize: ms a step, the event loop's host ms a step apart
    from the rounds, and (``profiled``) a profile of one more step
    (device busy share)."""
    from repro_torch.comm import make_session
    from repro_torch.core.base import build_round, root_key, split

    dev = w0.device
    init_on = problem if population is None else population.eval_problem()
    weights = (None if population is not None
               else problem.client_weights.cpu().numpy())
    session = make_session(
        cfg, m=init_on.m if population is None else population.m,
        keys=split(root_key(11, device=dev), commits + 1),
        state0=opt.init(init_on, w0), mask_dtype=w0.dtype, device=dev,
        population=population, client_weights=weights)
    fn = build_round(opt, problem, session, population=population)
    session.prepare(fn)
    session.begin_variant(None)
    torch.cuda.synchronize()
    events = _timed_events(session)
    ms = []
    for _ in range(commits):
        t0 = time.perf_counter()
        session.step(fn)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = events["s"] * 1e3 / commits
    profile = (_profile_steps(lambda: session.step(fn), 1) if profiled
               else None)
    store = getattr(session, "ef_store", None)
    return {"ms": ms, "median_ms": sorted(ms)[len(ms) // 2],
            "event_host_ms": host_ms, "profile": profile,
            "ef_store_bytes": store.nbytes if store is not None else None}


def _async_runs(problem, w0, w_star, runs, make_opt, label: str,
                population=None) -> dict:
    """Each run: run_rounds through the kernels (launches counted and
    checked), again through the plain versions (traces equal, losses
    bit-equal), then bare steps timed and profiled."""
    from repro_torch.comm import summarize
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops

    out = {}
    for name, rounds, cfg in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hist = run_rounds(make_opt(), problem if population is None
                          else population, w0, w_star, rounds=rounds,
                          comm=cfg)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        groups = (_groups_per_commit(hist) if cfg.async_mode
                  else [1] * rounds)
        executed = sum(groups) + (1 if cfg.async_mode else 0)  # + the probe
        want = _expected_launches(cfg, executed)
        check(counts == want, f"{label} {name}: launches {counts} != {want}")
        check(bool(np.isfinite(hist.loss).all()),
              f"{label} {name}: non-finite loss {hist.loss.tolist()}")
        check(hist.loss[-1] < hist.loss[0],
              f"{label} {name}: the loss did not fall {hist.loss.tolist()}")
        with ops.use_impl("ref"):
            plain = run_rounds(make_opt(), problem if population is None
                               else population, w0, w_star, rounds=rounds,
                               comm=cfg)
        check((hist.loss == plain.loss).all()
              and [t.to_dict() for t in hist.traces]
              == [t.to_dict() for t in plain.traces],
              f"{label} {name}: the run through the kernels "
              f"({hist.loss.tolist()}) differs from the plain versions' "
              f"({plain.loss.tolist()})")
        bare = _bare_commits(make_opt(), problem, w0, cfg, min(rounds, 20),
                             population)
        stale = (float(np.mean(hist.staleness)) if hist.staleness is not None
                 else 0.0)
        row = {"commits": rounds, "async": cfg.async_mode,
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "sim_time_s": float(hist.sim_time_s[-1]),
               "mean_staleness": stale, "groups_per_commit": groups,
               "rounds_executed": executed, "launches": counts,
               "launches_per_commit": {k: v / rounds for k, v in counts.items()
                                       if v},
               "run_rounds_ms_per_commit": hist.wall_time_s * 1e3 / rounds,
               "peak_memory_bytes": peak,
               "cumulative_bytes": float(hist.cumulative_bytes[-1]),
               "stats": summarize(hist.traces), "bare": bare}
        out[name] = row
        ms = bare["ms"]
        log(f"[{label}] {name}: {rounds} {'commits' if cfg.async_mode else 'rounds'}, "
            f"gap {hist.gap[0]:.3e} -> {hist.gap[-1]:.3e}; sim {row['sim_time_s']:.2f} s, "
            f"mean staleness {stale:.3f}, groups a commit "
            f"{np.mean(groups):.2f} (max {max(groups)}); launches {counts}")
        log(f"[{label}] {name}: bare {bare['median_ms']:.2f} ms a "
            f"{'commit' if cfg.async_mode else 'round'} median "
            f"({min(ms):.2f}..{max(ms):.2f}), event loop host "
            f"{bare['event_host_ms']:.3f} ms; profiled step busy "
            f"{bare['profile']['busy_share']:.1%} of "
            f"{bare['profile']['wall_us'] / 1e3:.2f} ms; run_rounds "
            f"{row['run_rounds_ms_per_commit']:.2f} ms with eval; peak "
            f"{peak / 2**30:.3f} GiB; trajectory equal to the plain versions'")
    return out


def phase_async(problem, w0, w_star) -> dict:
    """FLeNS+ at SUSY's full size under the asynchronous driver: the
    lock-step anchor, the three-driver race and the codec path."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import make_optimizer, run_rounds

    chan = _straggler_channel(problem.m)

    def flens_plus():
        return make_optimizer("flens_plus", k=SUSY["k"])

    # 1. the anchor: full-quorum async == sync, losses and bytes bit-equal
    sync = run_rounds(flens_plus(), problem, w0, w_star, rounds=3,
                      comm=CommConfig(channel=chan, seed=1))
    asy = run_rounds(flens_plus(), problem, w0, w_star, rounds=3,
                     comm=CommConfig(channel=chan, seed=1, async_mode=True))
    check(bool((sync.loss == asy.loss).all()
               and (sync.cumulative_bytes == asy.cumulative_bytes).all()),
          f"async anchor: sync {sync.loss.tolist()} != full-quorum async "
          f"{asy.loss.tolist()}")
    log(f"[async] anchor: 3 rounds sync == full-quorum async, losses and "
        f"bytes bit-equal ({asy.cumulative_bytes[-1]:.0f} B)")
    # 2. paper_common.sync_async_race (K = m / 4), 3. the codec path
    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]
    buf = max(2, problem.m // 4)
    runs = [("sync", 10, CommConfig(channel=chan, seed=1)),
            ("async_buf", 40, CommConfig(channel=chan, seed=1,
                                         async_mode=True, buffer_size=buf,
                                         staleness="inverse")),
            ("async_q50", 30, CommConfig(channel=chan, seed=1,
                                         async_mode=True, async_quantile=0.5,
                                         staleness="inverse")),
            ("async_buf comp+sched+ef", 20,
             CommConfig(channel=chan, seed=1, async_mode=True,
                        buffer_size=buf, staleness="inverse", codecs=codecs,
                        scheduler="bandwidth:0.5", error_feedback=True))]
    out = _async_runs(problem, w0, w_star, runs, flens_plus, "async")
    check(out["async_buf"]["sim_time_s"] < out["sync"]["sim_time_s"],
          "async: the buffered driver's clock did not run ahead of sync's")
    return {"anchor_loss": asy.loss.tolist(), "runs": out}


# ---------------------------------------------------------------------------
# 5e. client populations
# ---------------------------------------------------------------------------

# budgets the runs must stay within: a cohort-bounded run holds a few
# cohorts; materializing the population would hold its (m, n_shard, M)
# features, 100,000 x 64 x 16 x 8 B = 781 MiB at m = 100,000, and the
# SUSY rows again (687 MiB) over 5,000,000 rows
POP_BUDGET_MIB = {"synthetic": {"host": 256, "device": 256},
                  "dataset": {"host": 512, "device_over_rows": 512}}


class _HostRss:
    """The process's resident set, its high-water mark since ``start``:
    the kernel's own VmHWM where /proc/self/status has it, else the
    largest of VmRSS samples taken every 5 ms by a thread (``source``
    says which)."""

    def __init__(self):
        import threading

        self.source = ("VmHWM" if self._field("VmHWM") is not None
                       else "VmRSS sampled every 5 ms")
        self._peak = self.now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    @staticmethod
    def _field(name: str) -> "float | None":
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(name + ":"):
                    return int(line.split()[1]) / 1024
        return None

    def now(self) -> float:
        rss = self._field("VmRSS")
        if rss is None:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * 4096 / 2**20
        if not rss:  # no resident size reported: the rusage high-water
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        return rss

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self._peak = max(self._peak, self.now())

    def high_water(self) -> float:
        hwm = self._field("VmHWM")
        return hwm if hwm is not None else max(self._peak, self.now())

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def _materialize_ms(pop, cohort: int) -> float:
    ids = np.sort(np.random.default_rng(0).choice(pop.m, cohort,
                                                  replace=False))
    pop.materialize(ids)
    torch.cuda.synchronize()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        pop.materialize(ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def population_child() -> int:
    """The two population runs of phase 5e in a process of their own, so
    the host's RSS high-water mark (VmHWM) is theirs; prints one JSON
    line ``[populations] {...}``."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import (
        DatasetPopulation,
        SyntheticPopulation,
        logistic,
        make_optimizer,
        newton_solve,
    )
    from repro_torch.data import make_classification
    from repro_torch.kernels import _build

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = _card()
    _build.module()
    _build.module("codec")
    torch.zeros(1, device=dev)
    rss = _HostRss()

    # 1. examples/edge_clients.py's population row, EF on
    codecs = TRANSPORTS["comp+sched+ef"][1]
    w0 = torch.zeros(16, dtype=torch.float64, device=dev)

    def configs(q: float, rounds: int):
        base = dict(codecs=codecs, channel=ChannelModel(**POP_EDGE),
                    scheduler=f"uniform:{q}", seed=1, error_feedback=True)
        return [("sync", rounds, CommConfig(**base)),
                ("async_buf", rounds, CommConfig(
                    async_mode=True, buffer_size=50, staleness="inverse",
                    **base))]

    # the same runs on a population of 2000 (the same cohort of 100)
    # first: what the libraries they load (cuBLAS, cuSOLVER, the
    # profiler's) and their transients take is not the population's
    warm = SyntheticPopulation(m=2000, dim=16, seed=1, dirichlet_alpha=0.3,
                               device=dev)
    _async_runs(None, w0, newton_solve(warm.eval_problem(), w0),
                configs(0.05, 10), lambda: make_optimizer("flens_plus", k=8),
                "populations warm-up m=2000", population=warm)
    del warm
    torch.cuda.synchronize()
    base_hwm = rss.high_water()
    out = {"baseline_host_rss_mib": base_hwm, "rss_source": rss.source}
    pop = SyntheticPopulation(m=100_000, dim=16, seed=1, dirichlet_alpha=0.3,
                              device=dev)
    w_star = newton_solve(pop.eval_problem(), w0)
    runs = configs(1e-3, 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syn = _async_runs(None, w0, w_star, runs,
                      lambda: make_optimizer("flens_plus", k=8),
                      "populations m=100000", population=pop)
    hwm = rss.high_water()
    dev_peak = max(r["peak_memory_bytes"] for r in syn.values()) / 2**20
    budget = POP_BUDGET_MIB["synthetic"]
    check(hwm - base_hwm < budget["host"],
          f"m=100000: host RSS high-water grew {hwm - base_hwm:.0f} MiB "
          f"(budget {budget['host']})")
    check(dev_peak < budget["device"],
          f"m=100000: device peak {dev_peak:.1f} MiB (budget "
          f"{budget['device']})")
    out["synthetic"] = {"runs": syn, "host_rss_high_water_mib": hwm,
                        "host_growth_mib": hwm - base_hwm,
                        "device_peak_mib": dev_peak,
                        "materialize_ms": _materialize_ms(pop, 100),
                        "cohort": 100, "budget_mib": budget}
    log(f"[populations] m=100000: host RSS high-water ({rss.source}) "
        f"{hwm:.0f} MiB ({hwm - base_hwm:.0f} over the {base_hwm:.0f} MiB "
        f"high-water of the same runs at m = 2000; budget "
        f"{budget['host']}), device peak {dev_peak:.1f} MiB "
        f"(budget {budget['device']}); materialize a cohort of 100 "
        f"{out['synthetic']['materialize_ms']:.3f} ms; EF store "
        f"{syn['sync']['bare']['ef_store_bytes']} B")
    # 5f's population drivers: the same population at q = 1e-3, sync 10
    # rounds and async 10 commits, with telemetry off and on
    out["telemetry"] = _telemetry_runs(
        None, w0, w_star,
        [(name, rounds, cfg, lambda: make_optimizer("flens_plus", k=8), 0)
         for name, rounds, cfg in configs(1e-3, 10)],
        "m=100000", population=pop)
    out["dynamics"] = _population_dynamics(pop, w0, w_star, 1e-3)
    del pop

    # 2. the SUSY twin at its 5,000,000 rows as a DatasetPopulation
    X, y = make_classification(
        1, n=SUSY["n"], dim=SUSY["dim"], spectrum_decay=SUSY["spectrum_decay"],
        label_noise=SUSY["label_noise"], device=dev)
    dpop = DatasetPopulation(X, y, m=SUSY["m"], lam=SUSY["lam"],
                             objective=logistic, device=dev)
    del X, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows_mib = (dpop._rows_X.numel() * 8 + dpop._rows_y.numel() * 8) / 2**20
    hwm0 = rss.high_water()
    w0 = torch.zeros(SUSY["dim"], dtype=torch.float64, device=dev)
    w_star = newton_solve(dpop.eval_problem(), w0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds = _async_runs(None, w0, w_star,
                     [("sync", 10, CommConfig(scheduler="uniform:0.1",
                                              seed=1))],
                     lambda: make_optimizer("flens_plus", k=SUSY["k"]),
                     "populations SUSY", population=dpop)
    hwm = rss.high_water()
    rss.close()
    dev_peak = ds["sync"]["peak_memory_bytes"] / 2**20
    budget = POP_BUDGET_MIB["dataset"]
    check(hwm - hwm0 < budget["host"],
          f"SUSY population: host RSS high-water grew {hwm - hwm0:.0f} MiB")
    check(dev_peak - rows_mib < budget["device_over_rows"],
          f"SUSY population: device peak {dev_peak:.0f} MiB, rows "
          f"{rows_mib:.0f} MiB")
    out["dataset"] = {"runs": ds, "rows_mib": rows_mib,
                      "host_rss_high_water_mib": hwm,
                      "host_growth_mib": hwm - hwm0,
                      "device_peak_mib": dev_peak,
                      "materialize_ms": _materialize_ms(dpop, 100),
                      "cohort": 100, "budget_mib": budget}
    log(f"[populations] SUSY 5,000,000 rows, m=1000, uniform:0.1: device "
        f"peak {dev_peak:.0f} MiB ({dev_peak - rows_mib:.0f} over the "
        f"{rows_mib:.0f} MiB of rows; budget {budget['device_over_rows']}), "
        f"host RSS high-water {hwm:.0f} MiB (grew {hwm - hwm0:.0f}; budget "
        f"{budget['host']}); materialize a cohort of 100 "
        f"{out['dataset']['materialize_ms']:.3f} ms")
    print("[populations-json] " + json.dumps(out), flush=True)
    return 0


def phase_populations() -> dict:
    """The lock-step anchor across the population drivers, then the
    m = 100,000 and SUSY population runs in a child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import SyntheticPopulation, make_optimizer, run_rounds
    from repro_torch.core import newton_solve

    dev = _card()
    # every client's cycle takes the same time on the default channel, so
    # a full-quorum commit lists its members in id order, as sync does
    pop = SyntheticPopulation(m=200, dim=16, seed=2, device=dev)
    w0 = torch.zeros(16, dtype=torch.float64, device=dev)
    w_star = newton_solve(pop.eval_problem(), w0)
    codecs = TRANSPORTS["comp+sched+ef"][1]
    base = dict(seed=1, codecs=codecs, error_feedback=True)
    sync = run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                      rounds=3, comm=CommConfig(**base))
    asy = run_rounds(make_optimizer("flens_plus", k=8), pop, w0, w_star,
                     rounds=3, comm=CommConfig(async_mode=True, **base))
    check(bool((sync.loss == asy.loss).all()
               and (sync.cumulative_bytes == asy.cumulative_bytes).all()),
          f"population anchor: sync {sync.loss.tolist()} != async "
          f"{asy.loss.tolist()}")
    log("[populations] anchor: m=200 full scheduler, 3 rounds sync == "
        "full-quorum async, losses and bytes bit-equal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--population-child"],
        capture_output=True, text=True, timeout=900)
    record = None
    for line in proc.stdout.splitlines():
        if line.startswith("[populations-json] "):
            record = json.loads(line.split(" ", 1)[1])
        else:
            print(line, flush=True)
    check(proc.returncode == 0 and record is not None,
          f"populations child failed ({proc.returncode}): "
          f"{proc.stderr[-3000:]}")
    record["anchor_loss"] = asy.loss.tolist()
    return record


# ---------------------------------------------------------------------------
# 5f. telemetry
# ---------------------------------------------------------------------------

TELEMETRY_DIR = ROOT / "chiprun_out" / "telemetry"
# the kernel each op of FLeNS+ under comp+sched+ef takes at SUSY's shapes
# (n = 32, payload rows of 10-55 values): the warp routes
PROFILED_KERNELS = {"srht_apply": "srht_fwd_warp_kernel",
                    "srht_apply_t": "srht_t_warp_kernel",
                    "topk_mask": "topk_mask_warp_kernel",
                    "qint8_roundtrip": "qint8_warp_kernel"}
TELEMETRY_MODES = ("off", "null", "jsonl")
TELEMETRY_TURNS = 3  # off, null, jsonl; then backwards; then forwards


def _same_trajectory(a, b) -> bool:
    def key(h):
        return (h.loss.tolist(), h.grad_norm.tolist(),
                h.cumulative_bytes.tolist(), h.sim_time_s.tolist(),
                [t.to_dict() for t in h.traces or []],
                None if h.staleness is None else h.staleness.tolist())
    return key(a) == key(b)


def _trace_kernels(path: pathlib.Path) -> dict:
    """Launches of each profiled kernel in an exported Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in PROFILED_KERNELS.values()}


def _telemetry_runs(problem, w0, w_star, runs, label: str,
                    population=None) -> dict:
    """Each run (name, rounds, CommConfig or None, optimizer factory,
    rounds to profile): with obs=None, then with a jsonl sink (launches
    counted and checked, trajectory bit-equal, the stream checked by the
    port's report --check-schema, the profiled rounds' kernels read off
    the Chrome trace), then off / null sink / jsonl sink in turns for ms
    a step."""
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops
    from repro_torch.obs import TelemetryConfig, report

    target = problem if population is None else population
    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, rounds, cfg, make_opt, profile in runs:
        tag = f"{label}_{name}".replace(" ", "_").replace("=", "")
        path = TELEMETRY_DIR / f"{tag}.jsonl"
        trace_dir = TELEMETRY_DIR / f"{tag}_trace"

        def run(mode: str, dest: pathlib.Path, profile_rounds: int = 0):
            obs = None
            if mode != "off":
                dest.unlink(missing_ok=True)  # the jsonl sink appends
                obs = TelemetryConfig(
                    sink=f"jsonl:{dest}" if mode == "jsonl" else "null",
                    label=f"{label} {name}", profile_rounds=profile_rounds,
                    profile_dir=str(trace_dir))
            return run_rounds(make_opt(), target, w0, w_star, rounds=rounds,
                              comm=cfg, obs=obs)

        timed = TELEMETRY_DIR / f"{tag}_timed.jsonl"
        off = run("off", timed)
        shutil.rmtree(trace_dir, ignore_errors=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        on = run("jsonl", path, profile)
        counts = ops.launch_counts()
        check(_same_trajectory(on, off),
              f"{label} {name}: the trajectory with telemetry on differs "
              f"from the one with it off ({on.loss.tolist()} vs "
              f"{off.loss.tolist()})")
        check(report.main([str(path), "--check-schema"]) == 0,
              f"{label} {name}: {path} fails report --check-schema")
        if cfg is None:  # FLeNS: 3 srht_apply and 2 srht_apply_t a round
            executed = rounds
            want = {"fwht": 0, "srht_apply": 3 * rounds,
                    "srht_apply_t": 2 * rounds, **NO_CODEC, **NO_LM}
        else:
            executed = (sum(_groups_per_commit(on)) + 1 if cfg.async_mode
                        else rounds)  # + the async probe round
            want = _expected_launches(cfg, executed)
        check(counts == want,
              f"{label} {name}: launches {counts} != {want}")
        tel = on.telemetry
        row = {"rounds": rounds, "rounds_executed": executed,
               "launches": counts, "compile_s": tel["compile_s"],
               "exec_s_per_round": tel["exec_s_per_round"],
               "phase_s": tel["phase_s"],
               "setup_phase_s": tel["setup_phase_s"],
               "flight": tel["flight"], "metrics": tel["metrics"]}
        if profile:
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            check(len(traces) == 1, f"{label} {name}: profiler traces "
                  f"{[p.name for p in traces]} (want one)")
            got = _trace_kernels(traces[0])
            per_round = _expected_launches(cfg, 1)
            want_k = {kernel: profile * per_round[op]
                      for op, kernel in PROFILED_KERNELS.items()}
            check(got == want_k, f"{label} {name}: the profiled rounds "
                  f"launched {got} (want {want_k})")
            row["profiled_kernels"] = got
            row["profile_trace"] = str(traces[0].relative_to(ROOT))
        ms = {mode: [] for mode in TELEMETRY_MODES}
        for turn in range(TELEMETRY_TURNS):
            for mode in (TELEMETRY_MODES if turn % 2 == 0
                         else TELEMETRY_MODES[::-1]):
                hist = run(mode, timed)
                check(_same_trajectory(hist, off),
                      f"{label} {name}: the {mode} run's trajectory differs")
                ms[mode].append(hist.wall_time_s * 1e3 / rounds)
        row["ms_per_step"] = ms
        out[name] = row
        step = "commit" if cfg is not None and cfg.async_mode else "round"
        fl = tel["flight"]
        log(f"[telemetry] {label} {name}: {rounds} {step}s, trajectory "
            f"with telemetry on bit-equal to off; launches {counts}; "
            f"compile_s {tel['compile_s'] * 1e3:.2f} ms, exec_s_per_round "
            f"{tel['exec_s_per_round'] * 1e3:.3f} ms; flight "
            f"{fl['total']} events ({fl['kept']} kept, {fl['truncated']} "
            f"truncated)")
        log(f"[telemetry] {label} {name}: phase_s "
            + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in
                        sorted(tel["phase_s"].items(), key=lambda kv: -kv[1]))
            + "; setup " + ", ".join(
                f"{k} {v * 1e3:.2f} ms" for k, v in
                sorted(tel["setup_phase_s"].items(), key=lambda kv: -kv[1])))
        log(f"[telemetry] {label} {name}: ms a {step} (run_rounds, eval "
            f"included), {TELEMETRY_TURNS} turns each: " + "; ".join(
                f"{mode} " + " / ".join(f"{v:.3f}" for v in ms[mode])
                for mode in TELEMETRY_MODES))
        if profile:
            log(f"[telemetry] {label} {name}: the {profile} profiled rounds "
                f"launched {row['profiled_kernels']} ({row['profile_trace']})")
    return out


def _sink_us(record: dict, reps: int = 5, lines: int = 100) -> dict:
    """Host µs of the jsonl sink on this machine's disk: the first emit
    of a run (it creates and opens the file), a later emit, and the
    close; medians of ``reps`` fresh files of ``lines`` records."""
    from repro_torch.obs import make_sink

    path = TELEMETRY_DIR / "sink_cost.jsonl"
    first, later, close = [], [], []
    for _ in range(reps):
        path.unlink(missing_ok=True)
        sink = make_sink(f"jsonl:{path}")
        t0 = time.perf_counter()
        sink.emit(record)
        t1 = time.perf_counter()
        for _ in range(lines - 1):
            sink.emit(record)
        t2 = time.perf_counter()
        sink.close()
        t3 = time.perf_counter()
        first.append((t1 - t0) * 1e6)
        later.append((t2 - t1) * 1e6 / (lines - 1))
        close.append((t3 - t2) * 1e6)
    path.unlink(missing_ok=True)
    return {name: float(np.median(v)) for name, v in
            (("first_emit_us", first), ("emit_us", later),
             ("close_us", close))}


def phase_telemetry(card: str, problem, w0, w_star, populations: dict) -> dict:
    """The five drivers with telemetry on: FLeNS without transport, FLeNS+
    under comp+sched+ef on the edge channel (its first two rounds
    profiled) and async_buf (K = m/4) on the straggler channel at SUSY's
    full size here; the m = 100,000 population's sync and async runs came
    from the 5e child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FLeNS, make_optimizer

    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]

    def flens_plus():
        return make_optimizer("flens_plus", k=SUSY["k"])

    runs = [("flens", 10, None, lambda: FLeNS(k=SUSY["k"]), 0),
            ("flens_plus comp+sched+ef", 10,
             CommConfig(codecs=codecs, channel=_edge_channel(problem.m),
                        scheduler="bandwidth:0.5", error_feedback=True,
                        seed=1),
             lambda: FLeNS(k=SUSY["k"], variant="plus", sketch=sketch), 2),
            ("async_buf", 20,
             CommConfig(channel=_straggler_channel(problem.m), seed=1,
                        async_mode=True, buffer_size=max(2, problem.m // 4),
                        staleness="inverse"), flens_plus, 0)]
    out = {"susy": _telemetry_runs(problem, w0, w_star, runs, "SUSY"),
           "population": populations["telemetry"]}
    # what the jsonl sink itself costs here, on a round record of the
    # FLeNS+ run (the sink is the only difference between the null and
    # jsonl runs inside the round loop)
    stream = TELEMETRY_DIR / "SUSY_flens_plus_comp+sched+ef.jsonl"
    sink = _sink_us(json.loads(stream.read_text().splitlines()[0]))
    log(f"[telemetry] jsonl sink on this disk: first emit (creates and "
        f"opens the file) {sink['first_emit_us']:.1f} us, later emits "
        f"{sink['emit_us']:.1f} us each, close {sink['close_us']:.1f} us "
        f"(medians of 5 files of 100 records)")
    log(f"[telemetry] {card}: ms a step with telemetry off / on (null "
        f"sink) / on (jsonl sink), medians of {TELEMETRY_TURNS} turns:")
    for where, rows in out.items():
        for name, row in rows.items():
            med = {m: float(np.median(v)) for m, v in row["ms_per_step"].items()}
            log(f"[telemetry]   {where} {name}: " + " / ".join(
                f"{med[m]:.3f}" for m in TELEMETRY_MODES)
                + f" ms (jsonl - off {med['jsonl'] - med['off']:+.3f})")
    return {**out, "jsonl_sink": sink}


# ---------------------------------------------------------------------------
# 5g. scenario dynamics
# ---------------------------------------------------------------------------

DYNAMICS_DIR = TELEMETRY_DIR.parent / "dynamics"
# the counters repro_torch.dynamics feeds (robust_stats mirrored into
# telemetry, churn's departures, async retirements)
DYNAMICS_COUNTERS = ("clients_departed", "uploads_retired",
                     "uploads_corrupted", "uploads_clipped", "uploads_trimmed")
# examples/edge_clients.py:291-292: robust aggregation wants dense payloads
DENSE_CODECS = {"h_sk": "sympack+qint8", "sg": "qint8", "grad": "qint8"}
DYNAMICS_TURNS = ("off", "on", "on", "off")  # ms a step, in turns


def _churn_dynamics():
    """examples/edge_clients.py:260-274: churn with a diurnal uplink and
    regional outages."""
    from repro_torch.dynamics import ChannelProcess, DynamicsConfig

    return DynamicsConfig(
        churn="poisson:0.05", seed=1,
        channel=ChannelProcess(uplink_bytes_per_s="sin:24,0.5",
                               outage="outage:0.05,3,16", seed=1))


def _threat_dynamics(threat: "str | None", robust: "str | None" = None):
    from repro_torch.dynamics import DynamicsConfig

    return (DynamicsConfig(threat=threat, robust=robust, seed=1)
            if threat else None)


def _dynamics_runs(problem, w0, w_star, runs, label: str,
                   population=None) -> dict:
    """Each run (name, rounds, CommConfig, optimizer factory, rounds to
    profile): run_rounds with telemetry on through the kernels (launches
    counted and checked, the dynamics counters and the alive count read
    off the telemetry), again through the plain versions (trajectory and
    counters bit-equal), then, for a run with dynamics, bare steps with
    dynamics off and on in turns for ms a step."""
    from repro_torch.core import run_rounds
    from repro_torch.kernels import ops
    from repro_torch.obs import TelemetryConfig

    target = problem if population is None else population
    out = {}
    for name, rounds, cfg, make_opt, profile in runs:
        trace_dir = DYNAMICS_DIR / f"{label}_{name}_trace".replace(" ", "_")

        def run(impl=None, profile_rounds=0):
            obs = TelemetryConfig(label=f"{label} {name}",
                                  profile_rounds=profile_rounds,
                                  profile_dir=str(trace_dir))
            with ops.use_impl(impl):
                return run_rounds(make_opt(), target, w0, w_star,
                                  rounds=rounds, comm=cfg, obs=obs)

        shutil.rmtree(trace_dir, ignore_errors=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        hist = run(profile_rounds=profile)
        counts = ops.launch_counts()
        executed = (sum(_groups_per_commit(hist)) + 1 if cfg.async_mode
                    else rounds)  # + the async probe round
        want = _expected_launches(cfg, executed)
        check(counts == want, f"{label} {name}: launches {counts} != {want}")
        check(bool(np.isfinite(hist.loss).all()),
              f"{label} {name}: non-finite loss {hist.loss.tolist()}")
        plain = run("ref")
        metrics = hist.telemetry["metrics"]
        stats = {k: metrics["counters"][k] for k in DYNAMICS_COUNTERS
                 if k in metrics["counters"]}
        plain_stats = {k: plain.telemetry["metrics"]["counters"][k]
                       for k in stats}
        check(_same_trajectory(hist, plain) and stats == plain_stats,
              f"{label} {name}: the run through the kernels "
              f"({hist.loss.tolist()}, {stats}) differs from the plain "
              f"versions' ({plain.loss.tolist()}, {plain_stats})")
        row = {"rounds": rounds, "async": cfg.async_mode,
               "dynamics": (cfg.dynamics.describe() if cfg.dynamics
                            else None),
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "cumulative_bytes": hist.cumulative_bytes.tolist(),
               "sim_time_s": float(hist.sim_time_s[-1]),
               "rounds_executed": executed, "launches": counts,
               "stats": stats,
               "alive_last": metrics["gauges"].get("active_population")}
        if profile:
            traces = sorted(trace_dir.glob("*.pt.trace.json"))
            check(len(traces) == 1, f"{label} {name}: profiler traces "
                  f"{[p.name for p in traces]} (want one)")
            got = _trace_kernels(traces[0])
            per_round = _expected_launches(cfg, 1)
            want_k = {kernel: profile * per_round[op]
                      for op, kernel in PROFILED_KERNELS.items()}
            check(got == want_k, f"{label} {name}: the profiled rounds "
                  f"launched {got} (want {want_k})")
            row["profiled_kernels"] = got
            row["profile_trace"] = str(traces[0].relative_to(ROOT))
        step = "commit" if cfg.async_mode else "round"
        log(f"[dynamics] {label} {name}: {rounds} {step}s, gap "
            f"{hist.gap[0]:.3e} -> {hist.gap[-1]:.3e}, "
            f"{hist.cumulative_bytes[-1]:.0f} B, sim {row['sim_time_s']:.2f}"
            f" s; launches {counts}; equal to the plain versions'; "
            f"stats {stats}; alive at the last {step} {row['alive_last']}")
        if profile:
            log(f"[dynamics] {label} {name}: the {profile} profiled rounds "
                f"launched {row['profiled_kernels']} ({row['profile_trace']})")
        if cfg.dynamics is not None:
            off_cfg = dataclasses.replace(cfg, dynamics=None)
            ms = {"off": [], "on": []}
            for mode in DYNAMICS_TURNS:
                bare = _bare_commits(
                    make_opt(), problem, w0, cfg if mode == "on" else off_cfg,
                    min(rounds, 20), population, profiled=False)
                ms[mode].append(bare["median_ms"])
            row["bare_ms"] = ms
            med = {k: float(np.median(v)) for k, v in ms.items()}
            log(f"[dynamics] {label} {name}: bare ms a {step} (medians of "
                f"{min(rounds, 20)}, {len(DYNAMICS_TURNS) // 2} turns each) "
                f"without dynamics " + " / ".join(f"{v:.3f}" for v in ms["off"])
                + ", with " + " / ".join(f"{v:.3f}" for v in ms["on"])
                + f": {med['on'] - med['off']:+.3f} ms")
        out[name] = row
    return out


def _arms_gaps(runs: dict, label: str, clean: str, arms) -> dict:
    """The arms of one comparison transmit equal bytes (checked); their
    final-loss gaps to the clean run (printed, not checked)."""
    ref = runs[clean]["cumulative_bytes"]
    for arm in arms:
        check(runs[arm]["cumulative_bytes"] == ref,
              f"{label}: {arm} transmitted other bytes than {clean}")
    gaps = {arm: runs[arm]["loss"][-1] - runs[clean]["loss"][-1]
            for arm in arms}
    log(f"[dynamics] {label}: bytes equal across {[clean, *arms]}; final-loss "
        f"gap to {clean}: " + ", ".join(f"{a} {g:+.3e}"
                                         for a, g in gaps.items()))
    return gaps


def _population_dynamics(pop, w0, w_star, q: float) -> dict:
    """5g's population rows (examples/edge_clients.py:254-321) at
    ``uniform:q``, 10 rounds each: churn under the population codecs, and
    the noise coalition with and without the trimmed mean under the
    dense codecs beside the clean dense run."""
    from repro_torch.comm import ChannelModel, CommConfig
    from repro_torch.core import make_optimizer

    base = dict(channel=ChannelModel(**POP_EDGE), scheduler=f"uniform:{q}",
                seed=1)
    rows = [("churn", CommConfig(codecs=TRANSPORTS["comp+sched+ef"][1],
                                 dynamics=_churn_dynamics(), **base))]
    for arm, robust in (("clean", None), ("noise", None),
                        ("noise trimmed", "trimmed:0.1")):
        rows.append((arm, CommConfig(
            codecs=DENSE_CODECS, dynamics=_threat_dynamics(
                None if arm == "clean" else "noise:0.1,5", robust), **base)))
    DYNAMICS_DIR.mkdir(parents=True, exist_ok=True)
    label = f"m={pop.m}"
    runs = _dynamics_runs(
        None, w0, w_star,
        [(name, 10, cfg, lambda: make_optimizer("flens_plus", k=8), 0)
         for name, cfg in rows], label, population=pop)
    return {"m": pop.m, "runs": runs, "gaps": _arms_gaps(
        runs, f"{label} noise arms", "clean", ("noise", "noise trimmed"))}


def phase_dynamics(card: str, problem, w0, w_star, populations: dict) -> dict:
    """FLeNS+ at SUSY's full size under scenario dynamics: churn with a
    diurnal uplink and regional outages under comp+sched+ef on the edge
    channel (sync 10 rounds, its first two profiled, and async_buf K =
    m/4 20 commits), and bench_robust's arms (clean, signflip:0.1,
    signflip:0.1 with trimmed:0.1) under the dense codecs on the
    straggler channel; the m = 100,000 population rows came from the 5e
    child process."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import FLeNS

    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]

    def flens_plus():
        return FLeNS(k=SUSY["k"], variant="plus", sketch=sketch)

    churn = CommConfig(codecs=codecs, channel=_edge_channel(problem.m),
                       scheduler="bandwidth:0.5", error_feedback=True,
                       seed=1, dynamics=_churn_dynamics())
    runs = [("churn sync", 10, churn, flens_plus, 2),
            ("churn async_buf", 20, dataclasses.replace(
                churn, async_mode=True, buffer_size=max(2, problem.m // 4),
                staleness="inverse"), flens_plus, 0)]
    straggler = _straggler_channel(problem.m)
    for arm, threat, robust in (("clean", None, None),
                                ("signflip", "signflip:0.1", None),
                                ("signflip trimmed", "signflip:0.1",
                                 "trimmed:0.1")):
        runs.append((arm, 10, CommConfig(
            codecs=DENSE_CODECS, channel=straggler, seed=1,
            dynamics=_threat_dynamics(threat, robust)), flens_plus, 0))
    DYNAMICS_DIR.mkdir(parents=True, exist_ok=True)
    susy = _dynamics_runs(problem, w0, w_star, runs, "SUSY")
    gaps = _arms_gaps(susy, "SUSY bench_robust arms", "clean",
                      ("signflip", "signflip trimmed"))
    log(f"[dynamics] {card}: the cost of dynamics, bare ms a step with "
        f"dynamics minus without (medians of two turns each):")
    for where, rows in (("SUSY", susy),
                        (f"m={populations['m']}", populations["runs"])):
        for name, row in rows.items():
            if "bare_ms" in row:
                med = {k: float(np.median(v))
                       for k, v in row["bare_ms"].items()}
                log(f"[dynamics]   {where} {name}: {med['off']:.3f} -> "
                    f"{med['on']:.3f} ms ({med['on'] - med['off']:+.3f})")
    return {"susy": susy, "gaps": gaps, "population": populations}


# ---------------------------------------------------------------------------
# 6. long rows
# ---------------------------------------------------------------------------

def phase_long_rows() -> dict:
    """The three transforms past the single-pass length, bit-equal to
    their plain versions; fwht and srht_apply timed there."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import kernel_route

    dev = _card()
    cases = [(20000, 1 << 15, 64, (3,)), ((1 << 17) - 5, 1 << 17, 300, (2,)),
             (1 << 20, 1 << 20, 1000, (1,))]
    worst = {name: 0.0 for name in ("fwht", "srht_apply", "srht_apply_t")}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(2)
        for dim, n, k, batch in cases:
            signs, rows = _operator(gen, n, k, dtype, dev)
            x = torch.randn(batch + (dim,), generator=gen, dtype=dtype,
                            device=dev)
            y = torch.randn(batch + (k,), generator=gen, dtype=dtype,
                            device=dev)
            xp = torch.randn(batch + (n,), generator=gen, dtype=dtype,
                             device=dev)
            pairs = {
                "srht_apply": (ops.srht_apply(x, signs, rows, impl="cuda"),
                               ops.srht_apply(x, signs, rows, impl="ref")),
                "srht_apply_t": (
                    ops.srht_apply_t(y, signs, rows, dim, impl="cuda"),
                    ops.srht_apply_t(y, signs, rows, dim, impl="ref")),
                "fwht": (ops.fwht(xp, normalize=True, impl="cuda"),
                         ops.fwht(xp, normalize=True, impl="ref")),
            }
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} dim={dim} n={n} k={k}: kernel differs "
                      f"from the plain version (max abs err {err:.3e})")
    # fwht at (64, 2^17) (64 MB in float64) and (1, 2^20), no single
    # PyTorch call computing it (a dense H_n would take 137 GB); srht_apply
    # over two rows of 2^17 - 5 through the long-row path
    timings = []
    gen = torch.Generator(device=dev).manual_seed(4)
    for rows_n, log_n in ((64, 17), (1, 20)):
        n = 1 << log_n
        xp = torch.randn(rows_n, n, generator=gen, dtype=torch.float64, device=dev)
        item = xp.element_size()
        bound, bound_by = _bound_ms(xp.numel() * item, xp.numel() * item,
                                    rows_n * (n * log_n + n), torch.float64)

        def kern(xp=xp):
            return ops.fwht(xp, normalize=True, impl="cuda")

        def plain(xp=xp):
            return ops.fwht(xp, normalize=True, impl="ref")
        got, want = kern(), plain()
        label = f"({rows_n}, 2^{log_n}) f64, two passes"
        check(torch.equal(got, want), f"fwht {label}: kernel differs from "
              f"the plain version (max abs err {_max_err(got, want):.3e})")
        by_kernel = _device_kernels_ms(kern, 20)
        timings.append(dict(
            op="fwht", shape=label, dims=list(xp.shape), n=n,
            route=kernel_route("fwht", n), ms=_time_ms(kern, 20),
            device_ms=sum(by_kernel.values()), device_kernels_ms=by_kernel,
            plain_ms=_time_ms(plain, 5), library_ms=None, bound_ms=bound,
            bound_by=bound_by, max_abs_err=_max_err(got, want)))
        del xp, got, want
    n, k, dim = 1 << 17, 300, (1 << 17) - 5
    signs, rows = _operator(gen, n, k, torch.float64, dev)
    x = torch.randn(2, dim, generator=gen, dtype=torch.float64, device=dev)
    timings.append(dict(op="srht_apply", **_srht_fwd_row(
        "(2, 2^17 - 5) f64 -> k 300", x, signs, rows, None)))
    log(f"[long] {len(cases)} lengths x 2 dtypes x 3 kernels bit-equal to "
        f"the plain versions (max abs err {worst})")
    for r in timings:
        log(f"[long] {r['op']} {r['shape']} {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} (bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}); {r['route']}")
        for name, ms in r["device_kernels_ms"].items():
            log(f"[long]   {ms:.4f} ms  {name}")
    return {"max_abs_err": worst, "timings": timings}


# ---------------------------------------------------------------------------
# 7. codec parity
# ---------------------------------------------------------------------------

# (rows, P): the main path's payloads at the SUSY size (h_sk packed by
# sympack, sg, grad, h_sk crushed by top-k, a broadcast), ragged widths,
# the warp routes' limit (32 values a lane) and one past it on the block
# routes, and rows streamed from device memory
CODEC_SHAPES = [(1000, 55), (1000, 10), (1000, 18), (1000, 100), (1, 18),
                (7, 1), (5, 33), (3, 1000), (1000, 1024), (1000, 1025),
                (2, 5000), (4, 1 << 20)]


def _codec_inputs(gen, rows, p, dtype, dev):
    x = torch.randn(rows, p, generator=gen, dtype=dtype, device=dev)
    x = x * 10.0 ** torch.randint(-3, 4, (rows, 1), generator=gen,
                                  device=dev).to(dtype)
    # a tie-heavy row of small integers and an all-zero row
    x[0] = torch.randint(-3, 4, (p,), generator=gen, device=dev).to(dtype)
    if rows > 1:
        x[1] = 0.0
    u = torch.rand(rows, p, generator=gen, dtype=dtype, device=dev)
    return x, u


def phase_codec_parity() -> dict:
    from repro_torch.kernels import ops

    dev = _card()
    worst = {"topk_mask": 0.0, "qint8_roundtrip": 0.0}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(3)
        for rows, p in CODEC_SHAPES:
            x, u = _codec_inputs(gen, rows, p, dtype, dev)
            pairs = [("qint8_roundtrip",
                      ops.qint8_roundtrip(x, u, impl="cuda"),
                      ops.qint8_roundtrip(x, u, impl="ref"))]
            for kept in sorted({1, max(1, p // 10), max(1, p // 2), p}):
                pairs.append(("topk_mask", ops.topk_mask(x, kept, impl="cuda"),
                              ops.topk_mask(x, kept, impl="ref")))
            torch.cuda.synchronize()
            for name, got, want in pairs:
                err = _max_err(got, want)
                worst[name] = max(worst[name], err)
                check(torch.equal(got, want),
                      f"{name} {dtype} ({rows}, {p}): kernel differs from "
                      f"the plain version (max abs err {err:.3e})")
    log(f"[codec] {len(CODEC_SHAPES)} shapes x 2 dtypes bit-equal to the "
        f"plain versions (max abs err {worst})")
    return worst


# ---------------------------------------------------------------------------
# 8. transport at full size
# ---------------------------------------------------------------------------

def _edge_channel(m: int):
    """examples/edge_clients.py:81-91: log-spaced uplinks from 30 kB/s to
    3 MB/s, 10x downlinks, 80 ms latency, 20% stragglers x10, 10% drop."""
    from repro_torch.comm import ChannelModel

    rates = torch.logspace(math.log10(3e4), math.log10(3e6), m,
                           dtype=torch.float64).numpy()
    return ChannelModel(uplink_bytes_per_s=rates,
                        downlink_bytes_per_s=10.0 * rates, latency_s=0.08,
                        straggler_prob=0.20, straggler_slowdown=10.0,
                        dropout_prob=0.10)


def _codec_launches_per_round(cfg, uplinks) -> dict:
    """The codec kernels one round launches, read off the codec chain of
    each uplink payload (every stage is one batched launch; downlinks
    are identity here)."""
    from repro_torch.comm import QInt8Codec, TopKCodec

    counts = dict(NO_CODEC)
    for name in uplinks:
        codec = cfg.codec_for(name)
        while codec is not None:
            if isinstance(codec, TopKCodec):
                counts["topk_mask"] += 1
            if isinstance(codec, QInt8Codec):
                counts["qint8_roundtrip"] += 1
            codec = getattr(codec, "inner", None)
    return counts


def _transport_run(problem, w0, w_star, sketch, cfg, rounds, impl=None):
    from repro_torch.core import FLeNS, run_rounds
    from repro_torch.kernels import ops

    class GuardedFLeNS(FLeNS):
        """FLeNS+ that notes the server's guarded loss before each round."""

        guarded: list

        def round_signature(self, round_idx, state):
            self.guarded.append(float(state["loss"]))
            return super().round_signature(round_idx, state)

    opt = GuardedFLeNS(k=SUSY["k"], variant="plus", sketch=sketch)
    opt.guarded = []
    with ops.use_impl(impl):
        hist = run_rounds(opt, problem, w0, w_star, rounds=rounds, comm=cfg)
    return opt, hist


def _codec_host_path(x, u) -> dict:
    """Host microseconds per call of each step of the launch path of
    ``ops.qint8_roundtrip(..., impl="cuda")``, each step timed alone;
    beside them the steps the parent commit took otherwise (checks by
    torch.device, tiny from torch.finfo, the entry point by an f-string
    on a ctypes library, the ctypes call)."""
    import ctypes

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import codec as kcodec
    from repro_torch.kernels import fwht as kfwht

    suffix = kfwht.check_input(x, "x")
    entry = kcodec._entry("qint8_roundtrip", suffix)
    out = torch.empty_like(x)
    rows, p = kcodec._rows(x)
    tiny = kcodec._TINY[x.dtype]
    args = (x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, p, tiny,
            kfwht.stream_of(x))
    lib = ctypes.CDLL(_build.module("codec").__file__)
    by_ctypes = getattr(lib, f"repro_qint8_roundtrip_{suffix}")
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    by_ctypes.argtypes = [ptr, ptr, ptr, ll, ll, ctypes.c_double, ptr]
    by_ctypes.restype = ctypes.c_int

    def guard():
        with kfwht.device_guard(x):
            pass
    path = {
        "dispatch (resolve_impl, get_impl)":
            lambda: ops.get_impl("qint8_roundtrip",
                                 ops.resolve_impl("cuda", x), x),
        "checks (check_input x2, attributes, _rows)":
            lambda: (kfwht.check_input(x, "x"), kfwht.check_input(u, "u"),
                     u.dtype != x.dtype or u.get_device() != x.get_device()
                     or u.shape != x.shape, kcodec._rows(x)),
        "output (empty_like)": lambda: torch.empty_like(x),
        "entry point (_entry)":
            lambda: kcodec._entry("qint8_roundtrip", suffix),
        "tiny (cached)": lambda: kcodec._TINY[x.dtype],
        "device guard (device_guard)": guard,
        "stream (stream_of)": lambda: kfwht.stream_of(x),
        "launch (extension call)": lambda: entry(*args),
    }
    parent = {
        "checks by torch.device":
            lambda: (u.dtype != x.dtype or u.device != x.device
                     or u.shape != x.shape),
        "tiny (torch.finfo)": lambda: float(torch.finfo(x.dtype).tiny),
        "entry point (f-string getattr on ctypes)":
            lambda: getattr(lib, f"repro_qint8_roundtrip_{suffix}"),
        "launch (ctypes call)": lambda: by_ctypes(*args),
    }
    steps = {name: _host_us(fn) for name, fn in path.items()}
    return {"steps_us": steps, "steps_sum_us": sum(steps.values()),
            "call_us": _host_us(lambda: ops.qint8_roundtrip(x, u,
                                                            impl="cuda")),
            "parent_steps_us": {name: _host_us(fn)
                                for name, fn in parent.items()},
            "reps": HOST_REPS}


def _codec_timings(dev) -> dict:
    """Each codec kernel at its main-path shapes (and one wide shape that
    is not on the path), beside its bound, the plain version and, for
    top-k, torch.topk + scatter; events and the profiler's device time,
    the kernel that serves each shape, and the host path of
    qint8_roundtrip at its first shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.codec import codec_route

    gen = torch.Generator(device=dev).manual_seed(4)
    calls = {"topk_mask": [("h_sk crushed (m, k*k)", (1000, 100), 25),
                           ("grad (m, M)", (1000, 18), 2),
                           ("sg crushed (m, k)", (1000, 10), 5),
                           ("not a main-path shape", (1000, 16384), 1639)],
             "qint8_roundtrip": [("h_sk packed (m, k(k+1)/2)", (1000, 55), 0),
                                 ("grad (m, M)", (1000, 18), 0),
                                 ("sg (m, k)", (1000, 10), 0),
                                 ("not a main-path shape", (1000, 16384), 0)]}
    out = {}
    for name, shapes in calls.items():
        rows_out = []
        for label, (rows, p), kept in shapes:
            x, u = _codec_inputs(gen, rows, p, torch.float64, dev)
            item = x.element_size()
            if name == "topk_mask":
                def kern(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="cuda")

                def plain(x=x, kept=kept):
                    return ops.topk_mask(x, kept, impl="ref")

                def lib(x=x, kept=kept):
                    idx = torch.topk(x.abs(), kept, dim=1).indices
                    return torch.zeros_like(x).scatter_(1, idx,
                                                        x.gather(1, idx))
                read, count = x.numel() * item, x.numel() * (item + 2)
            else:
                def kern(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="cuda")

                def plain(x=x, u=u):
                    return ops.qint8_roundtrip(x, u, impl="ref")
                lib = None
                read, count = 2 * x.numel() * item, 7 * x.numel()
            bound, bound_by = _bound_ms(read, x.numel() * item, count,
                                        torch.float64)
            row = dict(
                shape=label, dims=[rows, p], kept=kept or None,
                route=codec_route(name, p, x.dtype),
                ms=_time_ms(kern, 200), device_ms=_device_ms(kern, 200),
                plain_ms=_time_ms(plain, 50),
                library_ms=None if lib is None else _time_ms(lib, 200),
                library_device_ms=(None if lib is None
                                   else _device_ms(lib, 200)),
                library="torch.topk + scatter" if lib else "none",
                bound_ms=bound, bound_by=bound_by,
                max_abs_err=_max_err(kern(), plain()))
            if name == "qint8_roundtrip" and not rows_out:
                row["host_path"] = _codec_host_path(x, u)
            rows_out.append(row)
        out[name] = rows_out
    return out


def _bare_ms(step, rounds: int = 10) -> list:
    """Host clock around each of ``rounds`` steps that end in a
    synchronize, after one warm step."""
    step()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return out


def _bare_transport_rounds(problem, w0, chan) -> dict:
    """FLeNS+ bare rounds (no per-round evaluation) without a transport
    and under comp+sched+ef, and a profile of three transport rounds."""
    from repro_torch.comm import CommConfig, make_session
    from repro_torch.core import FLeNS
    from repro_torch.core.base import build_round, root_key, split

    dev = problem.X.device
    sketch, codecs, _ = TRANSPORTS["comp+sched+ef"]
    opt = FLeNS(k=SUSY["k"], variant="plus", sketch=sketch)
    state = opt.init(problem, w0)
    keys = iter(split(root_key(9, device=dev), 32))

    def plain_step():
        nonlocal state
        state = opt.round(problem, state, next(keys))
    none_ms = _bare_ms(plain_step)
    cfg = CommConfig(codecs=codecs, channel=chan, scheduler="bandwidth:0.5",
                     error_feedback=True, seed=1)
    session = make_session(cfg, m=problem.m,
                           keys=split(root_key(10, device=dev), 32),
                           state0=opt.init(problem, w0),
                           mask_dtype=problem.X.dtype, device=dev)
    session.begin_variant(None)
    fn = build_round(opt, problem, session)
    comm_ms = _bare_ms(lambda: session.step(fn))
    profile = _profile_steps(lambda: session.step(fn), 3)
    med = sorted(none_ms)[len(none_ms) // 2], sorted(comm_ms)[len(comm_ms) // 2]
    log(f"[transport] bare FLeNS+ rounds: {med[0]:.2f} ms median without a "
        f"transport, {med[1]:.2f} ms under comp+sched+ef; profile of 3 "
        f"transport rounds: device busy {profile['busy_share']:.1%} of "
        f"{profile['wall_us'] / 3e3:.2f} ms/round")
    for r in profile["top"]:
        log(f"[transport]   {r['us_per_round']:9.1f} us/round x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    return {"no_transport_ms": none_ms, "comp_sched_ef_ms": comm_ms,
            "profile": profile}


def phase_transport(problem, w0, w_star) -> dict:
    from repro_torch.comm import CommConfig
    from repro_torch.kernels import ops

    dev = _card()
    rounds = 10
    chan = _edge_channel(problem.m)
    uplinks = ("h_sk", "sg", "grad", "loss")  # FLeNS+ with the guard
    out = {"rounds": rounds, "runs": {}}
    launches = dict(NO_CODEC)
    for name, (sketch, codecs, up_bytes) in TRANSPORTS.items():
        cfg = CommConfig(codecs=codecs, channel=chan,
                         scheduler="bandwidth:0.5", error_feedback=True,
                         seed=1)
        per_round = _codec_launches_per_round(cfg, uplinks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        opt, hist = _transport_run(problem, w0, w_star, sketch, cfg, rounds)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"fwht": 0, "srht_apply": 4 * rounds,
                "srht_apply_t": 3 * rounds, **NO_LM,
                **{op: n * rounds for op, n in per_round.items()}}
        check(counts == want, f"{name} launches {counts} != {want}")
        for op in NO_CODEC:
            launches[op] += counts[op]
        guarded = opt.guarded
        check(all(math.isfinite(v) for v in guarded)
              and bool(torch.isfinite(torch.as_tensor(hist.loss)).all()),
              f"{name}: non-finite loss")
        check(all(b <= a for a, b in zip(guarded, guarded[1:])),
              f"{name}: the guarded loss rose: {guarded}")
        check(hist.loss[-1] < hist.loss[0], f"{name}: the loss did not fall")
        delivered_bytes = {float(v) for tr in hist.traces
                           for v in tr.bytes_up if v}
        check(delivered_bytes == {float(up_bytes)},
              f"{name}: uplink bytes per delivering client "
              f"{delivered_bytes} != {up_bytes}")
        _, plain = _transport_run(problem, w0, w_star, sketch, cfg, rounds,
                                  impl="ref")
        check((hist.loss == plain.loss).all()
              and (hist.cumulative_bytes == plain.cumulative_bytes).all()
              and (hist.sim_time_s == plain.sim_time_s).all(),
              f"{name}: the run through the kernels ({hist.loss.tolist()}) "
              f"differs from the run through the plain versions "
              f"({plain.loss.tolist()})")
        per_round_bytes = [float(b) for b in
                           hist.cumulative_bytes[1:] - hist.cumulative_bytes[:-1]]
        run = {"sketch": sketch, "codecs": codecs,
               "launches": counts, "codec_launches_per_round": per_round,
               "loss": hist.loss.tolist(), "gap": hist.gap.tolist(),
               "guarded_loss": guarded,
               "uplink_bytes_per_delivering_client": up_bytes,
               "bytes_per_round": per_round_bytes,
               "sim_time_s": float(hist.sim_time_s[-1]),
               "ms_per_round": hist.wall_time_s * 1e3 / rounds,
               "plain_ms_per_round": plain.wall_time_s * 1e3 / rounds,
               "peak_memory_bytes": peak,
               "ef_residuals": hist.ef_residuals,
               "delivered_per_round": [int(tr.delivered.sum())
                                       for tr in hist.traces]}
        out["runs"][name] = run
        log(f"[transport] {name} ({sketch}): gap "
            + " ".join(f"{g:.3e}" for g in hist.gap))
        log(f"[transport] {name}: launches {counts}; {up_bytes} B up per "
            f"delivering client, {sum(per_round_bytes) / rounds:.0f} B per "
            f"round; {run['sim_time_s']:.2f} simulated s; "
            f"{run['ms_per_round']:.2f} ms per round "
            f"(plain versions {run['plain_ms_per_round']:.2f}); peak memory "
            f"{peak / 2**30:.2f} GiB; same trajectory through the plain "
            f"versions")
    out["launches"] = launches
    out["bare"] = _bare_transport_rounds(problem, w0, chan)
    out["kernels"] = _codec_timings(dev)
    for name, rows in out["kernels"].items():
        for r in rows:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}, device "
                        f"{r['library_device_ms']:.4f} ({r['library']})")
            log(f"[transport] {name:<15} {r['shape']:<28} {r['dims']} "
                f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} "
                f"[{r['route']}] (bound {r['bound_ms']:.6f} by "
                f"{r['bound_by']}, plain {r['plain_ms']:.4f}, library {lib})")
    host = out["kernels"]["qint8_roundtrip"][0]["host_path"]
    log(f"[transport] qint8_roundtrip (1000, 55) host path, us a call over "
        f"{host['reps']} calls: whole call {host['call_us']:.2f}; "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["steps_us"].items())
        + "; the parent's way: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["parent_steps_us"].items()))
    return out


# ---------------------------------------------------------------------------
# 9. flash parity
# ---------------------------------------------------------------------------

# the flash kernels against their plain version: (tq, tk) x (H, Hkv) x D
# in both dtypes (q_offset = tk - tq keeps causal rows non-empty), then
# windows, non-causal, q_offset with a window, and rows that see no key;
# bfloat16 takes the wgmma kernel, float32 the 3xTF32 kernel
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_ROUTE = {torch.float32: "tf32x3", torch.bfloat16: "sm90"}
FLASH_SHAPES = [(64, 64), (100, 100), (32, 96), (1, 128), (2048, 2048)]
FLASH_HEADS = [(4, 4), (8, 1), (32, 4)]
FLASH_EXTRA = [  # (tq, tk, H, Hkv, D, causal, window, q_offset, block_k)
    (100, 100, 4, 4, 64, True, 1, 0, 1024),
    (100, 100, 8, 1, 128, True, 7, 0, 1024),
    (100, 100, 8, 1, 112, True, 7, 0, 64),
    (2048, 2048, 4, 1, 256, True, 512, 0, 1024),
    (2048, 2048, 16, 2, 128, True, 512, 0, 1024),
    (2048, 2048, 8, 2, 256, True, 128, 0, 1024),
    (64, 48, 4, 4, 64, False, None, 0, 1024),
    (48, 200, 4, 2, 64, False, 16, 70, 32),
    (32, 96, 8, 2, 64, True, 20, 500, 1024),
    (4, 8, 1, 1, 8, True, 2, 20, 4),  # no row sees a key
    (64, 200, 8, 2, 64, True, 16, 300, 64),  # no row sees a key, ragged tk
    (4096, 4096, 4, 1, 64, True, None, 0, 1024),  # rows of up to 8192 keys
    (8192, 8192, 4, 1, 64, True, None, 0, 1024),
    (8192, 8192, 4, 1, 128, True, None, 0, 1024),
]
# head dims that are not a multiple of 8, in both dtypes: the tf32x3
# kernel (bf16 D 200 would take the sm90 kernel and is left out)
FLASH_ODD_D = [(100, 100, 4, 2, 12, True, None, 0, 1024),
               (70, 90, 2, 1, 13, True, None, 20, 1024)]
FLASH_ODD_D_F32 = [(130, 130, 4, 1, 200, True, 48, 0, 1024)]


def _flash_inputs(gen, b, tq, tk, h, hkv, d, dtype, dev):
    q = torch.randn(b, tq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, tk, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, tk, hkv, d, generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash_parity() -> dict:
    from repro_torch.kernels import ops

    dev = _card()
    cases = []
    for tq, tk in FLASH_SHAPES:
        for h, hkv in FLASH_HEADS:
            for d in (64, 128, 256):
                cases.append((tq, tk, h, hkv, d, True, None, tk - tq, 1024))
    cases += FLASH_EXTRA
    worst = {"sm90 bfloat16": 0.0, "tf32x3 float32": 0.0,
             "tf32x3 bfloat16": 0.0}
    rows = []
    for dtype, tol in FLASH_TOL.items():
        gen = torch.Generator(device=dev).manual_seed(5)
        route = FLASH_ROUTE[dtype]
        extra = FLASH_ODD_D + (FLASH_ODD_D_F32 if dtype == torch.float32
                               else [])
        ops.reset_launch_counts()
        for i, (tq, tk, h, hkv, d, causal, window, q_offset,
                block_k) in enumerate(cases + extra):
            q, k, v = _flash_inputs(gen, 2 if tq < 2048 else 1, tq, tk, h,
                                    hkv, d, dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      block_k=block_k)
            got = ops.flash_attention(q, k, v, impl="cuda", **kw)
            want = ops.flash_attention(q, k, v, impl="ref", **kw)
            torch.cuda.synchronize()
            err = _max_err(got.float(), want.float())
            name = str(dtype).split(".")[-1]
            on = route if i < len(cases) else "tf32x3"
            worst[f"{on} {name}"] = max(worst[f"{on} {name}"], err)
            label = (f"{name} tq={tq} tk={tk} H={h} Hkv={hkv} D={d} "
                     f"causal={causal} window={window} q_offset={q_offset} "
                     f"block_k={block_k}")
            rows.append({"case": label, "route": on, "max_abs_err": err})
            log(f"[flash parity] {label} ({on}): max abs err {err:.3e}")
            check(got.dtype == dtype and err <= tol,
                  f"flash_attention {label}: kernel differs from the plain "
                  f"version by {err:.3e} > {tol}")
        counts = ops.launch_counts()
        want_routes = {"sm90": 0, "tf32x3": 0}
        want_routes[route] += len(cases)
        want_routes["tf32x3"] += len(extra)
        got_routes = {r: counts[f"flash_attention_{r}"] for r in want_routes}
        check(got_routes == want_routes,
              f"flash parity {name}: launches by route {got_routes} != "
              f"{want_routes}")
    log(f"[flash parity] {len(cases)} cases x 2 dtypes (+ "
        f"{len(FLASH_ODD_D) + len(FLASH_ODD_D_F32)} f32 and "
        f"{len(FLASH_ODD_D)} bf16 head dims not a multiple of 8 on the "
        f"tf32x3 kernel) within float32 "
        f"{FLASH_TOL[torch.float32]}, bfloat16 {FLASH_TOL[torch.bfloat16]}; "
        f"each on its route (worst {worst})")
    return {"worst": worst, "cases": rows}


# ---------------------------------------------------------------------------
# 10. serve: TinyLlama-1.1B through the continuous-batching engine
# ---------------------------------------------------------------------------

SERVE = dict(arch="tinyllama-1.1b", max_batch=4, cache_len=4096, requests=8,
             min_prompt=100, max_prompt=2000, new_tokens=64)
BF16_ULPS = 4  # bf16 prefill logits: kernel vs plain within 4 ulps of max|logit|
F32_LOGIT_TOL = 1e-3


def _serve_requests(vocab: int):
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1,
                           SERVE["requests"])
    return [Request(uid=i, prompt=[int(t) for t in
                                   rng.integers(0, vocab, int(n))],
                    max_new_tokens=SERVE["new_tokens"])
            for i, n in enumerate(lengths)]


def _serve_model(dtype):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.base import root_key
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(SERVE["arch"]), dtype=dtype,
                              param_dtype=dtype)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(root_key(0, device=torch.device("cuda", 0)))
    torch.cuda.synchronize()
    return cfg, model, params, time.perf_counter() - t0


def _run_engine(model, params, reqs) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(model, params, max_batch=SERVE["max_batch"],
                           cache_len=SERVE["cache_len"])
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while engine.queue or engine.active.any():
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(all(r.done for r in reqs), "serve: a request did not complete")
    generated = sum(len(r.generated) for r in reqs)
    return {"engine": engine, "launches": counts, "wall_s": wall,
            "steps": steps, "generated_tokens": generated,
            "tokens_per_s": generated / wall}


def _prefill_logits(model, params, tokens, impl=None):
    from repro_torch.kernels import ops

    with ops.use_impl(impl):
        logits, _ = model.prefill(params, {"inputs": tokens},
                                  cache_len=tokens.shape[1])
    return logits.float()


def _profile_call(fn) -> dict:
    """One profiled call of ``fn``: its wall and device busy time, the
    flash forward's device time and the flash backward's, and the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in kernels)
    # flash_attention_sm90_kernel<...> in bf16, flash_attention_tf32x3_kernel<...> in f32
    flash = sum(t for name, t, _ in kernels if "flash_attention" in name)
    # flash_bwd_{delta,dkdv,dq}_kernel<...>
    flash_bwd = sum(t for name, t, _ in kernels if "flash_bwd" in name)
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us, "flash_us": flash,
            "flash_bwd_us": flash_bwd,
            "flash_share_of_device": flash / busy if busy else 0.0,
            "flash_share_of_wall": flash / wall_us,
            "top": [{"kernel": n[:90], "us": t, "launches": c}
                    for n, t, c in top]}


def _prefill_profile(model, params, tokens) -> dict:
    return _profile_call(lambda: model.prefill(
        params, {"inputs": tokens}, cache_len=tokens.shape[1]))


def phase_serve() -> dict:
    """TinyLlama-1.1B at full width and depth in bf16 (random weights from
    seed 0): 8 requests through the engine, prefill by bucket, decode at
    batch 4, the kernel against the plain version on a 2048-token prefill,
    and a profile of that prefill."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import _bucket

    dev = _card()
    torch.cuda.empty_cache()
    cfg, model, params, init_s = _serve_model(torch.bfloat16)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {"arch": cfg.arch_id, "n_layers": L, "d_model": cfg.d_model,
           "dtype": "bfloat16", "init_s": init_s}
    with torch.no_grad():
        # warm: first use of every matmul shape of a prefill and a decode
        warm = torch.randint(0, cfg.vocab, (1, 128), generator=gen, device=dev)
        model.prefill(params, {"inputs": warm}, cache_len=256)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reqs = _serve_requests(cfg.vocab)
        buckets = [min(_bucket(len(r.prompt)), SERVE["cache_len"])
                   for r in reqs]
        run = _run_engine(model, params, reqs)
        engine = run.pop("engine")
        peak = torch.cuda.max_memory_allocated()
        want = {"fwht": 0, "srht_apply": 0, "srht_apply_t": 0, **NO_CODEC,
                "flash_attention": L * len(reqs),
                "flash_attention_sm90": L * len(reqs),
                "flash_attention_tf32x3": 0, **NO_BWD}
        check(run["launches"] == want,
              f"serve launches {run['launches']} != {want} (one launch of "
              f"the tensor-core kernel per layer per prefill)")
        check(all(len(r.generated) == SERVE["new_tokens"] for r in reqs),
              "serve: a request stopped short of max_new_tokens")

        # decode at batch 4 on the engine's caches: no kernel launch
        state = engine.state
        state["index"] = torch.tensor([2000, 1500, 1000, 500],
                                      dtype=torch.int32, device=dev)
        toks = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=dev)
        ops.reset_launch_counts()

        def decode():
            nonlocal state
            _, state = model.decode_step(params, state, toks)
        decode_ms = _bare_ms(decode, 20)
        check(ops.launch_counts()["flash_attention"] == 0,
              "serve: decode launched the flash kernel")
        decode_profile = _profile_steps(decode, 3)
        del engine, state

        # every bucket the request lengths can reach (128..2048)
        prefill_ms = {}
        for b in (128, 256, 512, 1024, 2048):
            tokens = torch.randint(0, cfg.vocab, (1, b), generator=gen,
                                   device=dev)
            ms = _bare_ms(lambda: model.prefill(
                params, {"inputs": tokens}, cache_len=SERVE["cache_len"]), 3)
            prefill_ms[b] = sorted(ms)[1]

        tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                               device=dev)
        got = _prefill_logits(model, params, tokens)
        want_l = _prefill_logits(model, params, tokens, impl="ref")
        err = _max_err(got, want_l)
        top = float(want_l.abs().max())
        tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
        agree = bool((got.argmax(-1) == want_l.argmax(-1)).all())
        log(f"[serve] 2048-token prefill logits, kernel vs plain: max abs "
            f"err {err:.4e} (tolerance {tol:.4e} = {BF16_ULPS} bf16 ulps at "
            f"max |logit| {top:.3f}); argmax equal: {agree}")
        check(err <= tol, f"serve: prefill logits through the kernel differ "
              f"from the plain version by {err:.4e} > {tol:.4e}")
        profile = _prefill_profile(model, params, tokens)

    out.update(run)
    out.update({
        "prompt_lengths": [len(r.prompt) for r in reqs], "buckets": buckets,
        "peak_memory_bytes": peak,
        "decode_ms_batch4": decode_ms, "decode_profile": decode_profile,
        "prefill_ms_by_bucket": prefill_ms,
        "prefill_tokens_per_s_by_bucket":
            {b: b / ms * 1e3 for b, ms in prefill_ms.items()},
        "logits_2048": {"max_abs_err": err, "tolerance": tol,
                        "max_abs_logit": top, "argmax_equal": agree},
        "prefill_2048_profile": profile})
    med = sorted(decode_ms)[len(decode_ms) // 2]
    log(f"[serve] {cfg.arch_id} bf16, {L} layers, d {cfg.d_model}: init "
        f"{init_s:.2f} s; engine {run['generated_tokens']} tokens for "
        f"{len(reqs)} requests (prompts {out['prompt_lengths']}) in "
        f"{run['wall_s']:.3f} s, {run['steps']} steps, "
        f"{run['tokens_per_s']:.1f} tokens/s; launches {run['launches']}; "
        f"peak memory {peak / 2**30:.3f} GiB")
    log(f"[serve] decode at batch 4: {med:.3f} ms per step median "
        f"({min(decode_ms):.3f}..{max(decode_ms):.3f}); profile of 3 steps: "
        f"device busy {decode_profile['busy_share']:.1%} of "
        f"{decode_profile['wall_us'] / 3e3:.3f} ms/step")
    for r in decode_profile["top"][:6]:
        log(f"[serve]   {r['us_per_round']:9.1f} us/step x"
            f"{r['launches_per_round']:.0f}  {r['kernel']}")
    for b, ms in prefill_ms.items():
        log(f"[serve] prefill {b:5d} tokens: {ms:.3f} ms "
            f"({b / ms * 1e3:,.0f} tokens/s)")
    log(f"[serve] profile of a 2048-token prefill: flash kernel "
        f"{profile['flash_us'] / 1e3:.3f} ms = "
        f"{profile['flash_share_of_device']:.1%} of device time "
        f"({profile['device_busy_us'] / 1e3:.3f} ms), "
        f"{profile['flash_share_of_wall']:.1%} of wall "
        f"({profile['wall_us'] / 1e3:.3f} ms)")
    for r in profile["top"]:
        log(f"[serve]   {r['us']:10.1f} us x{r['launches']:<4d} {r['kernel']}")
    del params
    torch.cuda.empty_cache()
    return out


def _isolated_generate(model, params, prompt, n_new):
    """Exact-length prefill + greedy decode of one request alone; returns
    the tokens and each step's top-2 logit margin."""
    dev = params["embed"]["table"].device
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    logits, state = model.prefill(params, {"inputs": toks},
                                  cache_len=SERVE["cache_len"])
    state["index"] = torch.tensor([len(prompt)], dtype=torch.int32,
                                  device=dev)
    out, margins = [], []
    for step in range(n_new):
        if step:
            logits, state = model.decode_step(
                params, state, torch.tensor([[out[-1]]], device=dev))
        top2 = torch.topk(logits[0].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        out.append(int(torch.argmax(logits[0])))
    return out, margins


def phase_serve_f32() -> dict:
    """The same model in float32 (TF32 off): the engine's tokens equal each
    request's isolated prefill + greedy decode, token for token."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    torch.cuda.empty_cache()
    cfg, model, params, init_s = _serve_model(torch.float32)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        reqs = _serve_requests(cfg.vocab)
        run = _run_engine(model, params, reqs)
        run.pop("engine")
        peak = torch.cuda.max_memory_allocated()
        n = cfg.n_layers * len(reqs)
        got = {k: run["launches"][k] for k in NO_LM}
        check(got == {**NO_LM, "flash_attention": n,
                      "flash_attention_tf32x3": n},
              f"serve f32 launches {run['launches']} (one launch of the "
              f"tf32x3 kernel per layer per prefill)")
        min_margin = math.inf
        for r in reqs:
            want, margins = _isolated_generate(model, params, r.prompt,
                                               r.max_new_tokens)
            min_margin = min(min_margin, min(margins))
            if r.generated != want:
                step = next(i for i, (a, b) in enumerate(zip(r.generated,
                                                             want)) if a != b)
                raise SmokeFailure(
                    f"serve f32: request {r.uid} (prompt {len(r.prompt)}) "
                    f"differs from its isolated generation at step {step}: "
                    f"engine {r.generated[step]} vs isolated {want[step]}, "
                    f"top-2 margin there {margins[step]:.3e}")
        gen = torch.Generator(device=dev).manual_seed(7)
        tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                               device=dev)
        err = _max_err(_prefill_logits(model, params, tokens),
                       _prefill_logits(model, params, tokens, impl="ref"))
        check(err <= F32_LOGIT_TOL, f"serve f32: prefill logits through the "
              f"kernel differ from the plain version by {err:.3e}")
        ms = _bare_ms(lambda: model.prefill(
            params, {"inputs": tokens}, cache_len=SERVE["cache_len"]), 5)
        prefill_ms = sorted(ms)[len(ms) // 2]
        profile = _prefill_profile(model, params, tokens)
    log(f"[serve f32] {len(reqs)} requests x {SERVE['new_tokens']} tokens: "
        f"engine == isolated prefill + greedy decode, token for token "
        f"(smallest top-2 margin {min_margin:.3e}); engine "
        f"{run['tokens_per_s']:.1f} tokens/s in {run['wall_s']:.3f} s; "
        f"2048-token prefill logits kernel vs plain {err:.3e} (tolerance "
        f"{F32_LOGIT_TOL}); peak memory {peak / 2**30:.3f} GiB; init "
        f"{init_s:.2f} s")
    log(f"[serve f32] prefill 2048 tokens: {prefill_ms:.3f} ms median of "
        f"{len(ms)} ({min(ms):.3f}..{max(ms):.3f}); profile: flash kernel "
        f"{profile['flash_us'] / 1e3:.3f} ms = "
        f"{profile['flash_share_of_device']:.1%} of device time "
        f"({profile['device_busy_us'] / 1e3:.3f} ms), wall "
        f"{profile['wall_us'] / 1e3:.3f} ms")
    for r in profile["top"]:
        log(f"[serve f32]   {r['us']:10.1f} us x{r['launches']:<4d} "
            f"{r['kernel']}")
    del params
    torch.cuda.empty_cache()
    return {**run, "init_s": init_s, "peak_memory_bytes": peak,
            "min_top2_margin": min_margin, "logits_2048_max_abs_err": err,
            "prefill_2048_ms": ms, "prefill_2048_profile": profile}


# ---------------------------------------------------------------------------
# 11. flash times
# ---------------------------------------------------------------------------

FLASH_TIMED = [  # (route, label, dtype, B, T, H, Hkv, D, window)
    ("sm90", "TinyLlama prefill (1, 2048, 32, 4, 64) bf16 causal",
     torch.bfloat16, 1, 2048, 32, 4, 64, None),
    ("sm90", "gemma3-1b local (1, 2048, 4, 1, 256) bf16 window 512",
     torch.bfloat16, 1, 2048, 4, 1, 256, 512),
    ("sm90", "qwen1.5 heads (1, 2048, 64, 8, 128) bf16 causal",
     torch.bfloat16, 1, 2048, 64, 8, 128, None),
    ("tf32x3", "TinyLlama prefill (1, 2048, 32, 4, 64) f32 causal",
     torch.float32, 1, 2048, 32, 4, 64, None),
    ("tf32x3", "qwen1.5 heads (1, 2048, 64, 8, 128) f32 causal",
     torch.float32, 1, 2048, 64, 8, 128, None),
    ("tf32x3", "gemma3-1b local (1, 2048, 4, 1, 256) f32 window 512",
     torch.float32, 1, 2048, 4, 1, 256, 512),
]


def _visible_pairs(t: int, window) -> int:
    """Query-key pairs a causal (windowed) self-attention of length t
    computes."""
    rows = torch.arange(t, dtype=torch.int64)
    lo = (rows - window + 1).clamp(min=0) if window else torch.zeros_like(rows)
    return int((rows - lo + 1).sum())


def _device_kernels_ms(fn, reps: int) -> dict:
    """Device time of each kernel ``fn`` launches, ms per call, from the
    profiler: free of the host dispatch that back-to-back event timing
    measures when a kernel is shorter than its launch path."""
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


def _device_ms(fn, reps: int) -> float:
    """Device time of the kernels ``fn`` launches, ms per call."""
    return sum(_device_kernels_ms(fn, reps).values())


def phase_flash_times() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {f"flash_attention_{route}": [] for route in FLASH_ROUTE.values()}
    for route, label, dtype, b, t, h, hkv, d, window in FLASH_TIMED:
        q, k, v = _flash_inputs(gen, b, t, t, h, hkv, d, dtype, dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window:
            pos = torch.arange(t, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

        def kern():
            return ops.flash_attention(q, k, v, window=window, impl="cuda")

        def plain():
            return ops.flash_attention(q, k, v, window=window, impl="ref")
        item = q.element_size()
        io = (2 * q.numel() + k.numel() + v.numel()) * item
        flops = 4 * d * h * b * _visible_pairs(t, window)
        bound, bound_by = _bound_ms(io, 0, flops, dtype)
        simt_bound = None
        if route == "tf32x3":
            # the least time for its work: three TF32 tensor-core products
            # for each float32 one, under the float32 SIMT bound
            simt_bound = bound
            bound, bound_by = _bound_ms(io, 0, 3 * flops, dtype,
                                        TF32_OPS_PER_S)
        ops.reset_launch_counts()
        got = kern()
        check(ops.launch_counts()[f"flash_attention_{route}"] == 1,
              f"flash times {label}: not on the {route} kernel")
        row = dict(shape=label, dims=[b, t, h, hkv, d], window=window,
                   ms=_time_ms(kern, 20), plain_ms=_time_ms(plain, 5),
                   library_ms=_time_ms(lib, 20),
                   device_ms=_device_ms(kern, 20),
                   library_device_ms=_device_ms(lib, 20),
                   library="F.scaled_dot_product_attention(enable_gqa=True)",
                   bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9,
                   simt_bound_ms=simt_bound,
                   max_abs_err=_max_err(got.float(), plain().float()),
                   library_max_abs_err=_max_err(
                       got.float(), lib().transpose(1, 2).float()))
        out[f"flash_attention_{route}"].append(row)
        peak = (f" at 3xTF32 on the tensor cores, FP32 SIMT bound "
                f"{simt_bound:.4f}" if simt_bound else "")
        log(f"[flash times] {label} ({route}): {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} (bound {bound:.4f} by {bound_by}{peak}, "
            f"{flops / 1e9:.2f} GFLOP; plain {row['plain_ms']:.4f}; SDPA "
            f"{row['library_ms']:.4f}, device {row['library_device_ms']:.4f}); "
            f"max abs err vs plain {row['max_abs_err']:.3e}, vs SDPA "
            f"{row['library_max_abs_err']:.3e}")
    return out


# ---------------------------------------------------------------------------
# 13. train: LM training through the flash-attention backward kernel
# ---------------------------------------------------------------------------

# (a) the backward kernel against its plain version, causal: (label, (B,
# T, H, Hkv, D), window); the training shape last
FLASH_BWD_SHAPES = [
    ("TinyLlama heads (1, 2048, 32, 4, 64) causal", (1, 2048, 32, 4, 64),
     None),
    ("qwen1.5 heads (1, 2048, 64, 8, 128) causal", (1, 2048, 64, 8, 128),
     None),
    ("gemma3-1b local (1, 2048, 4, 1, 256) window 512", (1, 2048, 4, 1, 256),
     512),
    ("TinyLlama training (2, 2048, 32, 4, 64) causal", (2, 2048, 32, 4, 64),
     None)]
# the largest |error| of each gradient over its largest |value|: bfloat16
# 2e-2 (the wgmma forward's P V in bfloat16, each gradient rounded to
# bfloat16), float32 1e-4 (the 3xTF32 forward's output and log-sum-exp)
FLASH_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TRAIN = dict(arch="tinyllama-1.1b", batch=2, seq=2048, steps=12, lr=3e-3,
             seed=0, f32_layers=4)
# the kernels' run against the plain versions' from the same init and
# batches: |CE difference| at each step over the plain CE, each gradient
# leaf of step 0 by its relative norm error. bfloat16: the two forwards
# round at other places (P V in bf16 in the wgmma kernel) and the
# differences grow through 22 layers and the steps; float32 (TF32 off):
# the kernels' float32 sums in their own order (the 3xTF32 forward within
# 2e-5 of its output), equal CE at the first steps, then grown by
# AdamW's normalised steps over a loss that spikes (1.8e-5 at step 9 on
# an H100)
TRAIN_TOL = {torch.bfloat16: {"ce": 1e-2, "grad": 5e-2},
             torch.float32: {"ce": 1e-4, "grad": 1e-4}}
HEAD = dict(m=8, per_client=64, seq=32, k=64, rounds=10, lam=1e-3)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _flash_bwd_row(label, dims, window, dtype, gen, dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    b, t, h, hkv, d = dims
    q, k, v = _flash_inputs(gen, b, t, t, h, hkv, d, dtype, dev)
    do = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    out, lse = kflash._forward(q, k, v, causal=True, window=window,
                               q_offset=0, block_k=1024, with_lse=True)
    check(torch.equal(out, kflash.flash_attention_cuda(q, k, v,
                                                       window=window)),
          f"flash backward {label}: the forward's output changes when it "
          f"writes its log-sum-exp")

    def kern():
        return kflash.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                               window=window)

    def plain():
        return ref.mha_blocked_grad(q, k, v, do, window=window)
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    rel = {g: _rel_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
    abs_err = max(_max_err(x.float(), w.float()) for x, w in zip(got, want))
    check(max(rel.values()) <= FLASH_BWD_TOL[dtype],
          f"flash backward {name} {label}: kernel differs from the plain "
          f"version by {rel} of max |grad| > {FLASH_BWD_TOL[dtype]}")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash backward {name} {label}: a second call differs")
    # the yardstick: SDPA's backward on the same inputs (heads second)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    if window:
        pos = torch.arange(t, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
    else:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    do_t = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(lib_out, (qt, kt, vt), do_t,
                                   retain_graph=True)
    # q, o, dO read and dq written; k, v read and dk, dv written; lse read
    io = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
    # five products (S, dP, dV, dK, dQ) of 2 D flops a visible pair a head
    flops = 10 * d * h * b * _visible_pairs(t, window)
    bound, bound_by = _bound_ms(io, 0, flops, dtype)
    simt_bound = None
    if dtype == torch.float32:
        simt_bound = bound
        bound, bound_by = _bound_ms(io, 0, 3 * flops, dtype, TF32_OPS_PER_S)
    by_kernel = _device_kernels_ms(kern, 10)
    row = dict(shape=f"{label} {name}", dims=list(dims), window=window,
               dtype=name, rel_err=rel, max_abs_err=abs_err,
               ms=_time_ms(kern, 10), device_ms=sum(by_kernel.values()),
               device_ms_by_kernel=by_kernel, plain_ms=_time_ms(plain, 2),
               library="SDPA backward (enable_gqa=True)",
               library_ms=_time_ms(lib, 10),
               library_device_ms=_device_ms(lib, 10), bound_ms=bound,
               bound_by=bound_by, simt_bound_ms=simt_bound,
               gflop=flops / 1e9)
    split = ", ".join(f"{key.split('::')[-1].split('<')[0]} {ms:.3f}"
                      for key, ms in by_kernel.items())
    peak = (f" at 3xTF32, FP32 SIMT bound {simt_bound:.4f}" if simt_bound
            else "")
    log(f"[train] flash backward {row['shape']}: rel err dq "
        f"{rel['dq']:.2e} dk {rel['dk']:.2e} dv {rel['dv']:.2e} (tol "
        f"{FLASH_BWD_TOL[dtype]}); {row['ms']:.4f} ms, device "
        f"{row['device_ms']:.4f} ({split}); bound {bound:.4f} by {bound_by}"
        f"{peak}, {flops / 1e9:.1f} GFLOP; plain {row['plain_ms']:.3f}; SDPA "
        f"backward {row['library_ms']:.4f}, device "
        f"{row['library_device_ms']:.4f}")
    return row


def phase_flash_bwd() -> dict:
    """(a): the backward kernel at its four shapes in both dtypes, and the
    forward with its log-sum-exp written bit-equal to the forward without
    over flash parity's self-attention shapes."""
    from repro_torch.kernels import flash_attention as kflash

    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = [_flash_bwd_row(label, dims, window, dtype, gen, dev)
            for dtype in FLASH_BWD_TOL
            for label, dims, window in FLASH_BWD_SHAPES]
    swept = 0
    for dtype in FLASH_BWD_TOL:
        cases = [(t, h, hkv, d, None) for t, t2 in FLASH_SHAPES if t == t2
                 for h, hkv in FLASH_HEADS for d in (64, 128, 256)]
        cases += [(tq, h, hkv, d, window) for tq, tk, h, hkv, d, causal,
                  window, q_offset, _ in FLASH_EXTRA
                  if tq == tk and q_offset == 0 and causal]
        for t, h, hkv, d, window in cases:
            q, k, v = _flash_inputs(gen, 1, t, t, h, hkv, d, dtype, dev)
            with_lse = kflash._forward(q, k, v, causal=True, window=window,
                                       q_offset=0, block_k=1024,
                                       with_lse=True)
            check(torch.equal(with_lse[0], kflash.flash_attention_cuda(
                q, k, v, window=window)) and bool(
                    torch.isfinite(with_lse[1]).all()),
                  f"flash forward {dtype} {(t, h, hkv, d, window)}: output "
                  f"with its log-sum-exp differs from the output without")
            swept += 1
    log(f"[train] flash forward with the log-sum-exp written: {swept} "
        f"self-attention shapes, output bit-equal to the forward without")
    return {"rows": rows, "lse_bitwise_cases": swept}


def _train_model(dtype, n_layers=None):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), dtype=dtype,
                              param_dtype=dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, LM(cfg)


def _train_run(model, params, batches, impl) -> dict:
    """12 AdamW steps from ``params`` on ``batches``, launch/train.py's
    schedule, through the kernels (impl None) or the plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import WARMUP_STEPS, train_step
    from repro_torch.optim import adamw_init, linear_warmup_cosine

    opt_state = adamw_init(params)
    ces, gnorms, ms = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.use_impl(impl):
        for step, batch in enumerate(batches):
            lr = linear_warmup_cosine(step, base_lr=TRAIN["lr"],
                                      warmup_steps=WARMUP_STEPS,
                                      total_steps=len(batches))
            t0 = time.perf_counter()
            params, opt_state, _, ce, gnorm = train_step(
                model, params, opt_state, batch, lr)
            ces.append(float(ce))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(gnorm))
    return {"params": params, "ce": ces, "gnorm": gnorms, "ms": ms,
            "launches": ops.launch_counts()}


def _step0_grads(model, params, batch) -> dict:
    """Step 0's gradients through the kernels and the plain versions:
    each leaf's relative norm error, the worst, and both losses."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.tree import leaves

    loss_k, _, grads_k = loss_and_grads(model, params, batch)
    with ops.use_impl("ref"):
        loss_r, _, grads_r = loss_and_grads(model, params, batch)
    errs = [float(torch.linalg.vector_norm((a.float() - b.float()))
                  / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
            for a, b in zip(leaves(grads_k), leaves(grads_r))]
    return {"loss": float(loss_k), "loss_plain": float(loss_r),
            "grad_rel_norm_err": max(errs), "leaves": len(errs)}


def _train_phase(dtype, batches, n_layers=None) -> "tuple[dict, tuple]":
    """(b) and (c): one model, the kernels' run and the plain versions'
    from one init on ``batches``; returns the record and (model, trained
    params)."""
    from repro_torch.core.base import root_key
    from repro_torch.launch.train import train_step
    from repro_torch.optim import adamw_init

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 in float32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg, model = _train_model(dtype, n_layers)
    name = str(dtype).split(".")[-1]
    tol = TRAIN_TOL[dtype]
    L, steps = cfg.n_layers, len(batches)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    params0 = model.init(root_key(TRAIN["seed"], device=dev))
    grads = _step0_grads(model, params0, batches[0])
    check(grads["grad_rel_norm_err"] <= tol["grad"],
          f"train {name}: step 0's gradients through the kernels differ from "
          f"the plain versions' by {grads['grad_rel_norm_err']:.3e} > "
          f"{tol['grad']} (relative norm, worst leaf)")
    torch.cuda.reset_peak_memory_stats()
    kern = _train_run(model, params0, batches, None)
    peak = torch.cuda.max_memory_allocated()
    plain = _train_run(model, params0, batches, "ref")
    want = {**NO_LM, "fwht": 0, "srht_apply": 0, "srht_apply_t": 0,
            **NO_CODEC, "flash_attention": 2 * L * steps,
            f"flash_attention_{FLASH_ROUTE[dtype]}": 2 * L * steps,
            **{op: L * steps for op in NO_BWD}}
    check(kern["launches"] == want,
          f"train {name}: launches {kern['launches']} != {want} (with remat "
          f"the forward kernel runs twice a layer a step, the backward once)")
    check(all(n == 0 for n in plain["launches"].values()),
          f"train {name}: the plain run launched {plain['launches']}")
    ce_k, ce_p = np.array(kern["ce"]), np.array(plain["ce"])
    ce_err = float(np.max(np.abs(ce_k - ce_p) / np.abs(ce_p)))
    check(np.isfinite(ce_k).all() and np.isfinite(ce_p).all(),
          f"train {name}: a CE is not finite: {kern['ce']} / {plain['ce']}")
    check(ce_err <= tol["ce"],
          f"train {name}: the CE trajectory through the kernels {kern['ce']} "
          f"differs from the plain versions' {plain['ce']} by {ce_err:.3e} "
          f"> {tol['ce']} (relative)")
    check(ce_k[-1] < ce_k[0], f"train {name}: the last CE {ce_k[-1]:.4f} is "
          f"not below the first {ce_k[0]:.4f}")
    params = kern.pop("params")
    del plain["params"]
    torch.cuda.empty_cache()

    # one more step of each, through the profiler (from the trained params)
    state = {"params": params, "opt": adamw_init(params)}

    def step():
        state["params"], state["opt"], *_ = train_step(
            model, state["params"], state["opt"], batches[0], 1e-5)
    profile = _profile_call(step)
    del state
    torch.cuda.empty_cache()
    steady = kern["ms"][1:]
    ms = float(np.median(steady))
    out = {"arch": cfg.arch_id, "dtype": name, "n_layers": L,
           "d_model": cfg.d_model, "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "steps": steps, "step0": grads, "ce": kern["ce"], "ce_plain": plain["ce"],
           "gnorm": kern["gnorm"], "gnorm_plain": plain["gnorm"],
           "ce_rel_err": ce_err, "tolerance": tol,
           "ms_per_step": kern["ms"], "ms_per_step_plain": plain["ms"],
           "ms_median": ms, "tokens_per_s": tokens / ms * 1e3,
           "plain_ms_median": float(np.median(plain["ms"][1:])),
           "peak_memory_bytes": peak, "launches": kern["launches"],
           "profile": profile, "flash_bwd_share_of_device":
               profile["flash_bwd_us"] / profile["device_busy_us"],
           "flash_fwd_share_of_device": profile["flash_share_of_device"]}
    log(f"[train] {cfg.arch_id} {name} {L} layers d {cfg.d_model}, batch "
        f"{TRAIN['batch']} x {TRAIN['seq']}: CE through the kernels "
        + " ".join(f"{c:.4f}" for c in kern["ce"]))
    log(f"[train]   plain versions' CE " + " ".join(
        f"{c:.4f}" for c in plain["ce"]) + f"; worst relative difference "
        f"{ce_err:.2e} (tol {tol['ce']}); step 0 loss {grads['loss']:.5f} vs "
        f"{grads['loss_plain']:.5f}, gradients' worst relative norm error "
        f"{grads['grad_rel_norm_err']:.2e} over {grads['leaves']} leaves "
        f"(tol {tol['grad']})")
    log(f"[train]   {ms:.2f} ms a step (median of steps 1-{steps - 1}; first "
        f"{kern['ms'][0]:.1f}), {out['tokens_per_s']:,.0f} tokens/s, plain "
        f"versions {out['plain_ms_median']:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {kern['launches']}")
    log(f"[train]   a profiled step: device busy "
        f"{profile['busy_share']:.1%} of {profile['wall_us'] / 1e3:.2f} ms; "
        f"flash backward {out['flash_bwd_share_of_device']:.1%} and forward "
        f"{out['flash_fwd_share_of_device']:.1%} of device time")
    for r in profile["top"][:8]:
        log(f"[train]     {r['us'] / 1e3:9.3f} ms x{r['launches']:<4d} "
            f"{r['kernel']}")
    return out, (model, params)


def phase_flens_head(model, params) -> dict:
    """(d): FLeNS, FedAvg and FedNewton on the head of the trained bf16
    backbone, examples/federated_llm.py's setting at D = 2048."""
    from repro_torch.core import make_optimizer, newton_solve, run_rounds
    from repro_torch.kernels import ops
    from repro_torch.optim import extract_features, head_problem

    dev = _card()
    cfg = model.cfg
    m, rounds = HEAD["m"], HEAD["rounds"]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(m * HEAD["per_client"],
                                            HEAD["seq"]))
    # the example's label, a sequence holding two tokens of the lowest
    # 1/32 of the vocab (8 of its 256), so positives keep its share
    labels = np.where((toks < cfg.vocab // 32).sum(axis=1) >= 2, 1.0, -1.0)
    feats = extract_features(model, params,
                             torch.tensor(toks, dtype=torch.int32, device=dev))
    check(feats.shape == (len(labels), cfg.d_model)
          and bool(torch.isfinite(feats).all()), "head: features not finite")
    prob = head_problem(feats, torch.tensor(labels, device=dev), m,
                        lam=HEAD["lam"])
    w0 = torch.zeros(prob.dim, dtype=torch.float64, device=dev)
    w_star = newton_solve(prob, w0, iters=40)
    out = {"features": list(feats.shape), "positives": float(
        (labels > 0).mean()), "rounds": rounds}
    for name, kw in (("flens", dict(k=HEAD["k"])),
                     ("fedavg", dict(lr=1.0, local_steps=5)),
                     ("fednewton", {})):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_rounds(make_optimizer(name, **kw), prob, w0, w_star,
                          rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        # FedAvg keeps the example's step (lr 1.0), made for its d = 128
        # features: on these it need not converge, and only its losses are
        # checked finite
        check(np.isfinite(hist.loss).all() and (
            name == "fedavg" or hist.gap[-1] < hist.gap[0]),
              f"head {name}: gap {hist.gap.tolist()}")
        want = {**NO_LM, **NO_CODEC, "fwht": 0, "srht_apply": 0,
                "srht_apply_t": 0}
        if name == "flens":
            want.update(srht_apply=3 * rounds, srht_apply_t=2 * rounds)
            with ops.use_impl("ref"):
                plain = run_rounds(make_optimizer(name, **kw), prob, w0,
                                   w_star, rounds=rounds)
            check((hist.loss == plain.loss).all()
                  and (hist.gap == plain.gap).all(),
                  f"head flens: through the kernels {hist.loss.tolist()} != "
                  f"through the plain versions {plain.loss.tolist()}")
        check(counts == want, f"head {name}: launches {counts} != {want}")
        out[name] = {"gap": hist.gap.tolist(), "loss": hist.loss.tolist(),
                     "uplink_floats": hist.uplink_floats,
                     "ms_per_round": wall / rounds * 1e3,
                     "launches": {op: n for op, n in counts.items() if n}}
        log(f"[train] head {name:>9}: D {prob.dim}, uplink/round "
            f"{hist.uplink_floats}, gap " + " ".join(
                f"{g:.1e}" for g in hist.gap[::2]) + f"; launches "
            f"{out[name]['launches']}"
            + ("; trajectory bit-equal to the plain versions'"
               if name == "flens" else ""))
    acc = float(((feats.double() @ w_star > 0)
                 == torch.tensor(labels > 0, device=dev)).double().mean())
    out["head_accuracy"] = acc
    log(f"[train] head accuracy at w*: {acc:.3f} (positives "
        f"{out['positives']:.2f})")
    return out


def phase_train() -> dict:
    """13: (a) the backward kernel, (b) TinyLlama-1.1B bf16 training, (c)
    its float32 twin at 4 layers, (d) the FLeNS head on (b)'s backbone."""
    from repro_torch.configs import get_config
    from repro_torch.data import FastLMStream

    t0 = time.perf_counter()
    record = {"flash_bwd": phase_flash_bwd()}
    t1 = time.perf_counter()
    batches = list(FastLMStream(get_config(TRAIN["arch"]).vocab,
                                TRAIN["seq"], TRAIN["batch"],
                                seed=TRAIN["seed"], device=_card()).batches(
                                    TRAIN["steps"]))
    record["stream_s"] = time.perf_counter() - t1
    log(f"[train] {TRAIN['steps']} FastLMStream batches of "
        f"{TRAIN['batch']} x {TRAIN['seq']} tokens in "
        f"{record['stream_s']:.2f} s (host)")
    record["bf16"], (model, params) = _train_phase(torch.bfloat16, batches)
    record["head"] = phase_flens_head(model, params)
    del model, params
    torch.cuda.empty_cache()
    record["f32"], _ = _train_phase(torch.float32, batches,
                                    TRAIN["f32_layers"])
    record["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 13 took {record['seconds']:.1f} s")
    return record


# ---------------------------------------------------------------------------

def main() -> int:
    card = phase_device()
    record = {"card": card, "build": phase_build(),
              "parity_max_abs_err": phase_parity(),
              "quickstart": phase_quickstart()}
    record["full_size"], susy = phase_full_size()
    record["covtype"] = phase_covtype()
    record["table_one"] = phase_table_one(*susy)
    record["async"] = phase_async(*susy)
    record["populations"] = phase_populations()
    record["telemetry"] = phase_telemetry(card, *susy,
                                          record["populations"])
    record["dynamics"] = phase_dynamics(card, *susy,
                                        record["populations"]["dynamics"])
    record["long_rows"] = phase_long_rows()
    record["codec_parity_max_abs_err"] = phase_codec_parity()
    record["transport"] = phase_transport(*susy)
    del susy
    torch.cuda.empty_cache()
    record["flash_parity"] = phase_flash_parity()
    record["serve"] = phase_serve()
    record["serve_f32"] = phase_serve_f32()
    record["flash_times"] = phase_flash_times()
    record["train"] = phase_train()
    # launches: the SRHT kernels from the full-size comm=None run (fwht is
    # the butterfly they share and is never launched on its own there),
    # the codec kernels from the two full-size transport runs, the
    # wgmma flash kernel from the bf16 engine run of the serve phase and
    # the tf32x3 one from the f32 engine run, the backward from the bf16
    # training run (one call of its three kernels a layer a step)
    train = record["train"]
    bwd_rows = train["flash_bwd"]["rows"]
    launches = {**record["full_size"]["launches"],
                **record["transport"]["launches"],
                "flash_attention_sm90":
                    record["serve"]["launches"]["flash_attention_sm90"],
                "flash_attention_tf32x3":
                    record["serve_f32"]["launches"]["flash_attention_tf32x3"],
                "flash_attention_bwd":
                    train["bf16"]["launches"]["flash_attention_bwd"]}
    # the backward's main row: the bf16 training shape
    timed = {**record["full_size"]["kernels"],
             **record["transport"]["kernels"], **record["flash_times"],
             "flash_attention_bwd": [bwd_rows[len(FLASH_BWD_SHAPES) - 1]]}
    parity = {**record["parity_max_abs_err"],
              **record["codec_parity_max_abs_err"],
              **{f"flash_attention_{route}": max(
                  e for key, e in record["flash_parity"]["worst"].items()
                  if key.startswith(route)) for route in ("sm90", "tf32x3")},
              "flash_attention_bwd": max(r["max_abs_err"] for r in bwd_rows)}
    for name, err in record["long_rows"]["max_abs_err"].items():
        parity[name] = max(parity[name], err)
    # the routes of srht_apply and fwht, each at a timed shape, with the
    # launches of the main-path run that takes it (SUSY: the warp route;
    # covtype: the register route)
    long_times = record["long_rows"]["timings"]
    covtype = record["covtype"]["srht_apply"]
    # the batched routes: SUSY's per-client call, launched by FedNS and
    # FedNDES in 5c; covtype's (not on a path here); the quickstart's,
    # launched by FedNS under the transport
    table = record["table_one"]
    batched = table["srht_apply_batched"]
    routes = {
        "srht_apply": [(timed["srht_apply"][0], launches["srht_apply"]),
                       (covtype[0], record["covtype"]["launches"]["srht_apply"]),
                       (covtype[-1], 0),
                       *[(r, 0) for r in long_times if r["op"] == "srht_apply"],
                       (batched[0], sum(table["optimizers"][name]["launches"]
                                        ["srht_apply"] for name in SKETCHED)),
                       (batched[1], 0),
                       (batched[2], table["fedns_transport"]["launches"]
                        ["srht_apply"])],
        "fwht": [*[(r, 0) for r in timed["fwht"]],
                 *[(r, 0) for r in long_times if r["op"] == "fwht"]],
    }
    kernels = []
    for name, meta in KERNELS.items():
        main_row = timed[name][0]
        entry = {
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": max(main_row["max_abs_err"], parity[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        }
        if name in routes:
            entry["routes"] = [
                {"kernel": r["route"], "shape": r["shape"], "dims": r["dims"],
                 "launches": count, "ms": r["ms"], "device_ms": r["device_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
                for r, count in routes[name]]
        kernels.append(entry)
    print("[record] " + json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--population-child"]:
        sys.exit(population_child())
    sys.exit(main())
