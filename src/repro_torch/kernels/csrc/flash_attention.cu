// Grouped-query flash attention for NVIDIA Hopper (sm_90a), float32 and
// bfloat16 inputs, (B, T, H, D) layout, head dim up to 256.
//
// Replaces the Pallas TPU kernel
//   flash_attention_pallas  (src/repro/kernels/flash_attention.py:72, body _fa_kernel)
// and computes its contract, repro.kernels.ref.mha_blocked (the plain
// version here is repro_torch.kernels.ref.mha_blocked): q is cast to
// float32 and multiplied by scale (rounded in float32) before the dot;
// masks are causal (kpos <= q_offset + row), a sliding window (kpos >
// qpos - window, window <= 0 meaning none) and the padding mask kpos < tk,
// each masked logit set to -2^30; the softmax is online in float32 with
// the running max starting at -inf; the output is acc / max(l, 1e-30),
// cast to q's type. The KV head of q head h is h / (H / Hkv): K and V are
// read per KV head and never expanded in memory.
//
// Which calls take it: float32 (the contract checks, held to 2e-5, which
// TF32 tensor cores would break) and bfloat16 head dims that are not a
// multiple of 8 (TMA cannot stride them). Other bfloat16 calls take the
// tensor-core kernel of csrc/flash_attention_sm90.cu (the wrapper's
// flash_route).
//
// What bounds it: operations. A causal TinyLlama prefill layer, (1, 2048,
// 32 heads, 4 KV heads, 64), does 4 * 64 * 32 * 2048 * 2049 / 2 = 17.2
// GFLOP: 0.2565 ms at the 67 TFLOP/s float32 SIMT peak, the units this
// kernel computes on (no tensor cores).
//
// What the design does about it: one block of 256 threads per (64-row q
// tile, q head, batch row). The q tile (scaled, float32) stays in shared
// memory; 64-key K and V tiles pass through shared memory (dynamic: a
// 64 x 256 float32 tile alone is 64 KB). Each thread holds a 4 x 4 tile of
// logits (rows rg*4+i, keys lane+16j) and a 4-row slice of the output
// accumulator (columns lane+16c), so each shared load feeds 2 FMAs (the
// logits) or more (P V); each row's running max, denominator and
// accumulator stay in the registers of the 16 threads that share the row.
// Unlike the TPU grid, the block skips key tiles that lie wholly above
// the causal diagonal or wholly outside the window of all its rows: for a
// row that sees a key this is exact (a masked tile adds exp(-2^30 - m) =
// 0, and tiles before the row's first visible key are wiped by alpha =
// exp(-2^30 - m) = 0, as in the reference). A row that sees no key at all
// gets the reference's value in closed form: every reference block adds
// exp(0) = 1 per key, so the output is the sum of v over all tk keys
// divided by nk * block_k of the op's block_k argument (empty_denom),
// computed in a second pass that runs only in blocks that hold such rows.
//
// Arithmetic is float32 FMAs: no TF32 and no bf16 products. Built without
// -fmad=false (the other sources need it for bit-equality; this one is
// held to a tolerance). Every entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;      // threads that share a group of rows
constexpr int kRows = 4;        // rows per thread: rg * 4 + i
constexpr int kKeys = kBK / kLanes;   // keys per thread per tile: lane + 16 j
constexpr int kPStride = kBK + 4;     // two row groups of a warp on other banks
constexpr float kMask = -1073741824.0f;  // -2^30
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads / kLanes * kRows == kBQ, "one row group per 16 threads");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max and sum over the 16 lanes of a row group (xor stays in the half warp)
__device__ __forceinline__ float group_max(float x) {
  for (int off = kLanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// rows [k0, k0 + kBK) of one KV head into a float32 tile of `width`
// columns (zero past d and past tk) with row stride `stride`
template <typename T>
__device__ void load_tile(const T* __restrict__ src, float* dst, int width, int stride,
                          int k0, int tk, int hkv, int kvh, int bb, int d) {
  for (int e = threadIdx.x; e < kBK * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    const int key = k0 + r;
    float x = 0.0f;
    if (key < tk && c < d) x = to_f32(src[(((long long)bb * tk + key) * hkv + kvh) * d + c]);
    dst[r * stride + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int tq, int tk, int h,
                       int hkv, int d, int causal, int window, int q_offset, float scale,
                       float empty_denom) {
  constexpr int kCols = DMAX / kLanes;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  // odd strides: the 16 keys of a load sit on 16 banks, and the two row
  // groups of a warp (4 rows apart) on different ones
  const int stride = d + 1;
  float* qs = smem;                     // kBQ x stride
  float* ks = qs + kBQ * stride;        // kBK x stride
  float* vs = ks + kBK * stride;        // kBK x DMAX
  float* ps = vs + kBK * DMAX;          // kBQ x kPStride

  const int tid = threadIdx.x;
  const int rg = tid / kLanes;
  const int lane = tid % kLanes;
  const int i0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / (h / hkv);
  const int bb = blockIdx.z;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int t = i0 + r;
    float x = 0.0f;
    if (t < tq) x = to_f32(q[(((long long)bb * tq + t) * h + head) * d + c]) * scale;
    qs[r * stride + c] = x;
  }

  int qpos[kRows];
  bool empty[kRows];
  bool any_empty = false;
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = i0 + rg * kRows + i;
    qpos[i] = q_offset + t;
    const int lo = window > 0 ? max(0, qpos[i] - window + 1) : 0;
    const int hi = causal ? min(tk - 1, qpos[i]) : tk - 1;
    empty[i] = t < tq && lo > hi;
    any_empty |= empty[i];
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // the key tiles any row of this block can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + kBQ, tq) - 1;
  const int b_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int b_hi = causal ? min(tk - 1, q_hi) : tk - 1;
  const int t_first = b_lo / kBK;
  const int t_last = b_hi >= b_lo ? b_hi / kBK : t_first - 1;

  for (int kt = t_first; kt <= t_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    load_tile(k, ks, d, stride, k0, tk, hkv, kvh, bb, d);
    load_tile(v, vs, DMAX, DMAX, k0, tk, hkv, kvh, bb, d);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(rg * kRows + i) * stride + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(lane + kLanes * j) * stride + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float rmax = kMask;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + lane + kLanes * j;
        const bool ok = kpos < tk && (!causal || kpos <= qpos[i]) &&
                        (window <= 0 || kpos > qpos[i] - window);
        if (!ok) s[i][j] = kMask;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(rg * kRows + i) * kPStride + lane + kLanes * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row group's P is written and read by its own 16 lanes

    for (int sk = 0; sk < kBK; ++sk) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(rg * kRows + i) * kPStride + sk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[sk * DMAX + lane + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // rows with no visible key: the sum of v over all keys / empty_denom
  if (__syncthreads_or(any_empty)) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!empty[i]) continue;
      l[i] = empty_denom;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
    }
    for (int k0 = 0; k0 < tk; k0 += kBK) {
      __syncthreads();
      load_tile(v, vs, DMAX, DMAX, k0, tk, hkv, kvh, bb, d);
      __syncthreads();
      for (int sk = 0; sk < kBK; ++sk) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (!empty[i]) continue;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] += vs[sk * DMAX + lane + kLanes * c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = i0 + rg * kRows + i;
    if (t >= tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = o + (((long long)bb * tq + t) * h + head) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + kLanes * c;
      if (col < d) row[col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int b, int tq,
                     int tk, int h, int hkv, int d, int causal, int window, int q_offset,
                     double scale, double empty_denom, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (d + 1) + (size_t)kBK * DMAX +
                       (size_t)kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((tq + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, tq, tk, h, hkv, d, causal, window,
      q_offset, (float)scale, (float)empty_denom);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int tq, int tk,
                   int h, int hkv, int d, int causal, int window, int q_offset, double scale,
                   double empty_denom, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 ||
      h > 65535 || b > 65535 || q_offset < 0)
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_d<T, 64>(q, k, v, o, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                           empty_denom, stream);
  if (d <= 128)
    return launch_d<T, 128>(q, k, v, o, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                            empty_denom, stream);
  if (d <= 256)
    return launch_d<T, 256>(q, k, v, o, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                            empty_denom, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

cudaError_t repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      int b, int tq, int tk, int h, int hkv, int d, int causal,
                                      int window, int q_offset, double scale,
                                      double empty_denom, void* stream) {
  return launch<float>(q, k, v, o, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                       empty_denom, stream);
}

cudaError_t repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       int b, int tq, int tk, int h, int hkv, int d, int causal,
                                       int window, int q_offset, double scale,
                                       double empty_denom, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, tq, tk, h, hkv, d, causal, window, q_offset,
                               scale, empty_denom, stream);
}

}  // extern "C"
