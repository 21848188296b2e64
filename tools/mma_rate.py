"""Measure the card's rate of ``mma.sync`` m16n8k8 TF32, the instruction
of the tf32x3 flash-attention kernel (``csrc/flash_attention.cu``):

    python3 tools/mma_rate.py

A kernel that does nothing else runs ``chains`` independent accumulators
a warp at 4 to 32 warps a SM. One JSON line per (chains, warps a SM) with
TFLOP/s and the nanoseconds an SM sub-partition spends per instruction,
beside the card's SM clock; then the card's name and power limit. Needs a
CUDA card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_rate_kernel(float* out, int iters) {
  const float x = 1.0f + (threadIdx.x & 31) * 1e-3f;
  const uint32_t bits = __float_as_uint(x) & 0xffffe000u;
  const uint32_t a[4] = {bits, bits, bits, bits}, b[2] = {bits, bits};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int iters, int chains,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chains == 1) mma_rate_kernel<1><<<blocks, threads, 0, st>>>(out, iters);
  else if (chains == 4) mma_rate_kernel<4><<<blocks, threads, 0, st>>>(out, iters);
  else mma_rate_kernel<8><<<blocks, threads, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(torch) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rate.cu"
    src.write_text(MMA_RATE_SRC)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    iters = 4096
    for chains in (1, 4, 8):
        for warps_per_sm in (4, 8, 16, 32):
            blocks, threads = sms * warps_per_sm // 4, 128
            out = torch.empty(blocks * threads, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                if fn(out.data_ptr(), blocks, threads, iters, chains, stream):
                    raise RuntimeError("mma_rate: launch failed")
            ms = _time_ms(torch, run, 5)
            n = blocks * threads // 32 * iters * chains
            print(json.dumps({
                "chains": chains, "warps_per_sm": warps_per_sm, "ms": ms,
                "tflops": n * 2048 / ms / 1e9,
                "sm_clock_mhz": smi.stdout.strip(),
                "ns_per_mma_per_subpartition": ms * 1e6 / (n / sms / 4)}),
                flush=True)


def _time_ms(torch, fn, reps: int = 20) -> float:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA card", file=sys.stderr)
        return 1
    mma_rate(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
