// Flash-attention backward for NVIDIA Hopper (sm_90a): the gradients dq,
// dk and dv of grouped-query attention, float32 and bfloat16 inputs in
// (B, T, H, D) layout, head dim up to 256.
//
// Replaces no Pallas kernel: the reference has no backward kernel (nothing
// under src/repro/kernels defines a custom_vjp), and its training gradient
// is JAX's derivative of the jnp ops of repro.kernels.ref.mha_blocked,
// reached from src/repro/models/attention.py:104. The forward kernels
// (csrc/flash_attention_sm90.cu, csrc/flash_attention.cu) fill their output
// through a raw pointer, which autograd cannot differentiate, so the port's
// training step needs this backward. Its plain version is
// repro_torch.kernels.ref.mha_blocked_grad, torch.autograd.grad of the
// plain forward.
//
// What it computes, in the FlashAttention-2 manner, from the forward's
// output o and its row log-sum-exp (float32 (B, H, T), written by the
// forward kernels when asked): with s = (q scale) . k (q cast to float32
// and multiplied by scale before the dot, as the contract does), p =
// exp(s - lse) on the pairs the masks keep (causal kpos <= qpos, window
// kpos > qpos - window) and 0 elsewhere,
//   delta_i = sum_c dO_ic o_ic,   dS = p (dO . v - delta_i),
//   dv = sum_i p dO,   dk = sum_i dS (q scale),   dq = scale sum_j dS k,
// with dk and dv summed over the H / Hkv query heads of their KV head. It
// takes only the training path's shapes: Tq = Tk and q_offset = 0, where
// every row sees at least its own key, so the forward's contract for rows
// that see no key never arises (the wrapper refuses other shapes).
//
// Three kernels, one launch each per call, no floating-point atomics (a
// run repeats bit for bit):
//   * flash_bwd_delta_kernel: delta, a warp a row;
//   * flash_bwd_dkdv_kernel: a block a (batch row, KV head, key tile of BK
//     keys) walks the group's query heads and the query tiles that see its
//     keys, and keeps dk and dv of its keys in registers;
//   * flash_bwd_dq_kernel: a block a (batch row, head, query tile of BQ
//     rows) walks the key tiles its rows see and keeps dq in registers.
// Each recomputes s and dO . v for its pairs, so the five products of the
// backward cost seven here.
//
// What bounds it: operations. The training shape (2, 2048, 32, 4, 64)
// causal does 5 products of 2 * 64 flops over 2 * 32 * 2,098,176 visible
// pairs: 85.9 GFLOP, 0.087 ms at the 989 TFLOP/s bf16 tensor-core peak and
// 1.28 ms at the 67 TFLOP/s float32 CUDA-core peak, against 25 MB of
// inputs and outputs (0.0075 ms at 3.35 TB/s).
//
// What the design does about it, for now: the arithmetic is float32 fma on
// the CUDA cores (loaded bf16 values widened), as the plain version
// computes; a simple kernel that is right. Each product is a register-tiled
// outer product from shared memory: 256 threads as 16 x 16, each owning a
// small tile of rows x columns, reading a few consecutive floats of each
// operand a step (one 16-byte load where four). To make both reads
// consecutive, an operand is kept in shared memory in the layout its
// product wants: transposed (head dim outermost) where the head dim is
// summed, row-major where it is an output column, so q and dO (dk/dv
// kernel) and k (dq kernel) are kept both ways. Tiles by head-dim width:
// D <= 64: BQ = BK = 64; D <= 128: BQ = 32, BK = 64; D <= 256: BQ = BK =
// 32, to fit shared memory (at most 221 KB a block). Tensor cores (wgmma)
// and TMA are later work.
//
// Every entry point launches on the given stream, allocates nothing (delta
// is the caller's scratch) and returns cudaGetLastError() after the
// launches, or the first error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // row padding of transposed tiles (floats)

template <int DT>
struct BwdTiles;
template <>
struct BwdTiles<64> {
  static constexpr int kBQ = 64, kBK = 64;
};
template <>
struct BwdTiles<128> {
  static constexpr int kBQ = 32, kBK = 64;
};
template <>
struct BwdTiles<256> {
  static constexpr int kBQ = 32, kBK = 32;
};

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

// N consecutive floats of shared memory, p aligned to N floats (N = 2, 4)
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  static_assert(N == 2 || N == 4, "two or four floats");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float (&r)[N]) {
  static_assert(N == 2 || N == 4, "two or four floats");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
}

// Rows [r0, r0 + R) of one head of a (B, T, heads, d) tensor, element (row,
// c) at src[base + row * row_stride + c], widened to float32 and times mul:
// row-major into dst (row stride DT) and/or transposed into dst_t (row
// stride R + kPad), zero past t and past d
template <typename T, int R, int DT>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long base,
                                          int row_stride, int r0, int t, int d, float mul,
                                          float* dst, float* dst_t) {
  for (int idx = threadIdx.x; idx < R * DT; idx += kThreads) {
    const int r = idx / DT, c = idx % DT;
    const int row = r0 + r;
    const float x =
        row < t && c < d ? to_f32(src[base + (long long)row * row_stride + c]) * mul : 0.0f;
    if (dst != nullptr) dst[r * DT + c] = x;
    if (dst_t != nullptr) dst_t[c * (R + kPad) + r] = x;
  }
}

// Two products over the head dim's first d columns: x[i][j] = sum_c
// a[c][ty NR + i] b[c][tx NC + j] and y likewise from (a2, b2); the
// operands are transposed tiles of row strides LA and LB
template <int NR, int NC, int LA, int LB>
__device__ __forceinline__ void dots2(float (&x)[NR][NC], float (&y)[NR][NC],
                                      const float* a, const float* b, const float* a2,
                                      const float* b2, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) x[i][j] = y[i][j] = 0.0f;
  const float* pa = a + ty * NR;
  const float* pb = b + tx * NC;
  const float* pa2 = a2 + ty * NR;
  const float* pb2 = b2 + tx * NC;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float ra[NR], rb[NC], ra2[NR], rb2[NC];
    lds<NR>(ra, pa + c * LA);
    lds<NC>(rb, pb + c * LB);
    lds<NR>(ra2, pa2 + c * LA);
    lds<NC>(rb2, pb2 + c * LB);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        x[i][j] = fmaf(ra[i], rb[j], x[i][j]);
        y[i][j] = fmaf(ra2[i], rb2[j], y[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int t, int causal, int window) {
  return qi < t && kj < t && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// delta[(b, head, i)] = sum_c dout[b, i, head, c] o[b, i, head, c], a warp
// a row of the (B * T * H, d) view
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int t, int h, int d) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* po = o + row * d;
  const T* pd = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(pd[c]), to_f32(po[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int head = (int)(row % h);
    const long long bi = row / h;  // b * t + i
    const int i = (int)(bi % t);
    delta[((bi / t) * h + head) * t + i] = s;
  }
}

// dk and dv of key tile blockIdx.y of KV head blockIdx.x, batch row
// blockIdx.z: over the group's heads and the query tiles that see the keys
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int t, int h, int hkv, int d,
                      int causal, int window, float scale) {
  constexpr int BQ = BwdTiles<DT>::kBQ, BK = BwdTiles<DT>::kBK;
  constexpr int LQ = BQ + kPad, LK = BK + kPad;
  constexpr int NI = BQ / 16;   // rows of S a thread (query rows)
  constexpr int NJ = BK / 16;   // columns of S a thread, rows of dk/dv (keys)
  constexpr int NC = DT / 64;   // 4-column groups of dk/dv a thread
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;            // DT x LK, transposed
  float* vt = kt + DT * LK;    // DT x LK, transposed
  float* qt = vt + DT * LK;    // DT x LQ, transposed (q scale)
  float* dot = qt + DT * LQ;   // DT x LQ, transposed
  float* qs = dot + DT * LQ;   // BQ x DT (q scale)
  float* dos = qs + BQ * DT;   // BQ x DT
  float* ps = dos + BQ * DT;   // BQ x BK
  float* dss = ps + BQ * BK;   // BQ x BK
  float* lses = dss + BQ * BK; // BQ
  float* dels = lses + BQ;     // BQ

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kvh = blockIdx.x, j0 = blockIdx.y * BK, bb = blockIdx.z;
  const int group = h / hkv;
  const long long kv_base = ((long long)bb * t * hkv + kvh) * d;
  load_rows<T, BK, DT>(k, kv_base, hkv * d, j0, t, d, 1.0f, nullptr, kt);
  load_rows<T, BK, DT>(v, kv_base, hkv * d, j0, t, d, 1.0f, nullptr, vt);

  // the query rows that see a key of this tile
  const int j_hi = min(j0 + BK, t) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 ? min(t - 1, j_hi + window - 1) : t - 1;

  float dk_acc[NJ][4 * NC], dv_acc[NJ][4 * NC];
#pragma unroll
  for (int r = 0; r < NJ; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int head = kvh * group + g;
    const long long q_base = ((long long)bb * t * h + head) * d;
    const long long stat = ((long long)bb * h + head) * t;
    for (int i0 = (i_lo / BQ) * BQ; i0 <= i_hi; i0 += BQ) {
      __syncthreads();  // every thread is done with the previous tile
      load_rows<T, BQ, DT>(q, q_base, h * d, i0, t, d, scale, qs, qt);
      load_rows<T, BQ, DT>(dout, q_base, h * d, i0, t, d, 1.0f, dos, dot);
      if (tid < BQ) {
        const int i = i0 + tid;
        lses[tid] = i < t ? lse[stat + i] : 0.0f;
        dels[tid] = i < t ? delta[stat + i] : 0.0f;
      }
      __syncthreads();

      // S and dO V^T: query rows ty NI + a, keys tx NJ + b
      float s[NI][NJ], dp[NI][NJ];
      dots2<NI, NJ, LQ, LK>(s, dp, qt, kt, dot, vt, d, ty, tx);
#pragma unroll
      for (int a = 0; a < NI; ++a) {
        const int r = ty * NI + a;
        float pr[NJ], dsr[NJ];
#pragma unroll
        for (int b = 0; b < NJ; ++b) {
          const bool ok = visible(i0 + r, j0 + tx * NJ + b, t, causal, window);
          const float p = ok ? expf(s[a][b] - lses[r]) : 0.0f;
          pr[b] = p;
          dsr[b] = p * (dp[a][b] - dels[r]);
        }
        sts<NJ>(ps + r * BK + tx * NJ, pr);
        sts<NJ>(dss + r * BK + tx * NJ, dsr);
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T (q scale): keys ty NJ + r, columns
      // 64 cc + 4 tx + e
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pj[NJ], dsj[NJ];
        lds<NJ>(pj, ps + i * BK + ty * NJ);
        lds<NJ>(dsj, dss + i * BK + ty * NJ);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          float o4[4], q4[4];
          lds<4>(o4, dos + i * DT + 64 * cc + 4 * tx);
          lds<4>(q4, qs + i * DT + 64 * cc + 4 * tx);
#pragma unroll
          for (int r = 0; r < NJ; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[r][4 * cc + e] = fmaf(pj[r], o4[e], dv_acc[r][4 * cc + e]);
              dk_acc[r][4 * cc + e] = fmaf(dsj[r], q4[e], dk_acc[r][4 * cc + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < NJ; ++r) {
    const int j = j0 + ty * NJ + r;
    if (j >= t) continue;
    T* rk = dk + kv_base + (long long)j * hkv * d;
    T* rv = dv + kv_base + (long long)j * hkv * d;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * cc + 4 * tx + e;
        if (c < d) {
          rk[c] = from_f32<T>(dk_acc[r][4 * cc + e]);
          rv[c] = from_f32<T>(dv_acc[r][4 * cc + e]);
        }
      }
  }
}

// dq of query tile (gridDim.y - 1 - blockIdx.y) of head blockIdx.x, batch
// row blockIdx.z: over the key tiles its rows see (the heaviest causal
// tiles start first)
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t, int h, int hkv, int d, int causal, int window,
                    float scale) {
  constexpr int BQ = BwdTiles<DT>::kBQ, BK = BwdTiles<DT>::kBK;
  constexpr int LQ = BQ + kPad, LK = BK + kPad;
  constexpr int NI = BQ / 16;   // columns of S^T a thread, rows of dq (query rows)
  constexpr int NJ = BK / 16;   // rows of S^T a thread (keys)
  constexpr int NC = DT / 64;   // 4-column groups of dq a thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // DT x LQ, transposed (q scale)
  float* dot = qt + DT * LQ;   // DT x LQ, transposed
  float* kt = dot + DT * LQ;   // DT x LK, transposed
  float* vt = kt + DT * LK;    // DT x LK, transposed
  float* ks = vt + DT * LK;    // BK x DT
  float* dst = ks + BK * DT;   // BK x BQ: dS transposed
  float* lses = dst + BK * BQ; // BQ
  float* dels = lses + BQ;     // BQ

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int head = blockIdx.x, bb = blockIdx.z;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = head / (h / hkv);
  const long long q_base = ((long long)bb * t * h + head) * d;
  const long long kv_base = ((long long)bb * t * hkv + kvh) * d;
  const long long stat = ((long long)bb * h + head) * t;
  load_rows<T, BQ, DT>(q, q_base, h * d, i0, t, d, scale, nullptr, qt);
  load_rows<T, BQ, DT>(dout, q_base, h * d, i0, t, d, 1.0f, nullptr, dot);
  if (tid < BQ) {
    const int i = i0 + tid;
    lses[tid] = i < t ? lse[stat + i] : 0.0f;
    dels[tid] = i < t ? delta[stat + i] : 0.0f;
  }

  // the keys the tile's rows see
  const int i_hi = min(i0 + BQ, t) - 1;
  const int j_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int j_hi = causal ? i_hi : t - 1;

  float acc[NI][4 * NC];
#pragma unroll
  for (int r = 0; r < NI; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.0f;

  for (int j0 = (j_lo / BK) * BK; j0 <= j_hi; j0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    load_rows<T, BK, DT>(k, kv_base, hkv * d, j0, t, d, 1.0f, ks, kt);
    load_rows<T, BK, DT>(v, kv_base, hkv * d, j0, t, d, 1.0f, nullptr, vt);
    __syncthreads();

    // S^T and (dO V^T)^T: keys ty NJ + a, query rows tx NI + b
    float s[NJ][NI], dp[NJ][NI];
    dots2<NJ, NI, LK, LQ>(s, dp, kt, qt, vt, dot, d, ty, tx);
#pragma unroll
    for (int a = 0; a < NJ; ++a) {
      const int j = ty * NJ + a;
      float dsr[NI];
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        const int r = tx * NI + b;
        const bool ok = visible(i0 + r, j0 + j, t, causal, window);
        const float p = ok ? expf(s[a][b] - lses[r]) : 0.0f;
        dsr[b] = p * (dp[a][b] - dels[r]);
      }
      sts<NI>(dst + j * BQ + tx * NI, dsr);
    }
    __syncthreads();

    // dq += dS K: query rows ty NI + r, columns 64 cc + 4 tx + e
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float dsi[NI];
      lds<NI>(dsi, dst + j * BQ + ty * NI);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float k4[4];
        lds<4>(k4, ks + j * DT + 64 * cc + 4 * tx);
#pragma unroll
        for (int r = 0; r < NI; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][4 * cc + e] = fmaf(dsi[r], k4[e], acc[r][4 * cc + e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int i = i0 + ty * NI + r;
    if (i >= t) continue;
    T* row = dq + q_base + (long long)i * h * d;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * cc + 4 * tx + e;
        if (c < d) row[c] = from_f32<T>(acc[r][4 * cc + e] * scale);
      }
  }
}

template <int DT>
constexpr size_t dkdv_smem() {
  constexpr int BQ = BwdTiles<DT>::kBQ, BK = BwdTiles<DT>::kBK;
  return sizeof(float) * (2 * DT * (BK + kPad) + 2 * DT * (BQ + kPad) + 2 * BQ * DT +
                          2 * BQ * BK + 2 * BQ);
}

template <int DT>
constexpr size_t dq_smem() {
  constexpr int BQ = BwdTiles<DT>::kBQ, BK = BwdTiles<DT>::kBK;
  return sizeof(float) *
         (2 * DT * (BQ + kPad) + 2 * DT * (BK + kPad) + BK * DT + BK * BQ + 2 * BQ);
}

template <typename T, int DT>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                     const float* delta, T* dq, T* dk, T* dv, int b, int t, int h, int hkv,
                     int d, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = BwdTiles<DT>::kBQ, BK = BwdTiles<DT>::kBK;
  static_assert(dkdv_smem<DT>() <= 232448 && dq_smem<DT>() <= 232448, "shared memory");
  auto dkdv = flash_bwd_dkdv_kernel<T, DT>;
  auto dqk = flash_bwd_dq_kernel<T, DT>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem<DT>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem<DT>());
  if (err != cudaSuccess) return err;
  if ((t + BQ - 1) / BQ > 65535 || (t + BK - 1) / BK > 65535) return cudaErrorInvalidValue;
  dkdv<<<dim3((unsigned)hkv, (unsigned)((t + BK - 1) / BK), (unsigned)b), kThreads,
         dkdv_smem<DT>(), stream>>>(q, k, v, dout, lse, delta, dk, dv, t, h, hkv, d, causal,
                                    window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((unsigned)h, (unsigned)((t + BQ - 1) / BQ), (unsigned)b), kThreads,
        dq_smem<DT>(), stream>>>(q, k, v, dout, lse, delta, dq, t, h, hkv, d, causal, window,
                                 scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, void* dk,
                   void* dv, int b, int t, int h, int hkv, int d, int causal, int window,
                   double scale, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 || d > 256 ||
      b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)b * t * h;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows, t, h, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  const T* dd = (const T*)dout;
  const float* ls = (const float*)lse;
  const float* dl = (const float*)delta;
  const float sc = (float)scale;
  if (d <= 64)
    return launch_d<T, 64>(qq, kk, vv, dd, ls, dl, (T*)dq, (T*)dk, (T*)dv, b, t, h, hkv, d,
                           causal, window, sc, st);
  if (d <= 128)
    return launch_d<T, 128>(qq, kk, vv, dd, ls, dl, (T*)dq, (T*)dk, (T*)dv, b, t, h, hkv, d,
                            causal, window, sc, st);
  return launch_d<T, 256>(qq, kk, vv, dd, ls, dl, (T*)dq, (T*)dk, (T*)dv, b, t, h, hkv, d,
                          causal, window, sc, st);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, o, dout, dq (B, T, H, d); k, v, dk, dv (B, T, Hkv, d); lse and the
// scratch delta float32 (B, H, T); all contiguous, of one dtype
cudaError_t repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int b,
                                          int t, int h, int hkv, int d, int causal, int window,
                                          double scale, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, t, h, hkv, d, causal,
                       window, scale, stream);
}

cudaError_t repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int b,
                                           int t, int h, int hkv, int d, int causal,
                                           int window, double scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, t, h, hkv, d,
                               causal, window, scale, stream);
}

}  // extern "C"
