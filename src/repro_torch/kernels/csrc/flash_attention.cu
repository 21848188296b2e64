// Grouped-query flash attention for NVIDIA Hopper (sm_90a) on the tensor
// cores in float32 accuracy: float32 and bfloat16 inputs, (B, T, H, D)
// layout, head dim up to 256.
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
// Which calls take it: float32 (the contract checks, held to 2e-5) and
// bfloat16 head dims that are not a multiple of 8 (TMA cannot stride
// them). Other bfloat16 calls take csrc/flash_attention_sm90.cu (the
// wrapper's flash_route, route "tf32x3" here).
//
// What bounds it: operations. A causal TinyLlama prefill layer, (1, 2048,
// 32 heads, 4 KV heads, 64), needs 4 * 64 * 32 * 2048 * 2049 / 2 = 17.2
// GFLOP: 0.2565 ms at the 67 TFLOP/s float32 SIMT peak. One TF32 product
// keeps 11 bits of each operand and misses the 2e-5 contract by ~45x, so
// both products are split (3xTF32): a = a_big + a_small with a_big =
// tf32(a), rounded to nearest with ties away from zero (cvt.rna's rule,
// done on the bits), and a_small = a - a_big (exact), of which an mma.sync
// TF32 operand reads the top 19 bits; a * b is taken as a_small b_big +
// a_big b_small + a_big b_big, the small * small term (~2^-22 of the
// product) dropped. That is 3 * 17.2 = 51.6 GFLOP on the tensor cores:
// 0.104 ms at the 494.7 TFLOP/s dense TF32 peak (wgmma), 0.164 ms at the
// ~314 TFLOP/s that mma.sync m16n8k8 TF32 reached on an H100 with nothing
// else to do (tools/mma_rate.py). bfloat16 K and V are exact
// in TF32 (a_small = 0): two products each.
//
// What the design does about it: both products run on the tensor cores as
// mma.sync.m16n8k8 TF32 with float32 accumulators (wgmma's TF32 form needs
// both operands K-major, and V is not K-major for P V).
//   * One block per (q tile, q head, batch row); each warp owns kM m-tiles
//     of 16 q rows (no row is shared between warps), whose rows live in the
//     fragments of the m16n8k8 layout: lane = 4 g + t holds rows g and g + 8,
//     columns 2t and 2t + 1 of every 8-column C tile. At D <= 64 a warp
//     owns two m-tiles, so each K and V fragment, once loaded and split,
//     feeds six products.
//   * The scaled q tile (float32, zero past d up to a multiple of 8) stays in
//     shared memory and is split as its A fragments are loaded. K and V tiles
//     come through two stages of shared memory by cp.async (16-byte copies,
//     zero-filled past tk and d): tile j + 1 is in flight while tile j is
//     computed. Row strides are 8 mod 32 floats for Q and K (the 8-byte
//     fragment loads of a half warp, rows g and columns 2t, hit 32 banks) and
//     4 mod 16 for V (rows 2t and 2t + 1, column g, hit 32 banks).
//   * S = Q K^T: the k order of each 8-wide step is permuted, the same way
//     for A and B (A columns t, t + 4 and B rows t, t + 4 are dims 2t, 2t +
//     1), so each fragment is one 8-byte load. The softmax runs on S's C
//     fragments (2^x by ex2.approx); a row's max and sum take two xor
//     shuffles in its quad.
//   * O += P V without a shuffle: S's C fragment of keys 8c..8c+7 is P's A
//     fragment when A columns t and t + 4 are read as keys 2t and 2t + 1
//     (a0 = c0, a1 = c2, a2 = c1, a3 = c3); V's B fragment is read in the
//     same key order (b0 = V[2t][g], b1 = V[2t + 1][g]). The unrolled
//     products hold no branch: 8-column tiles past a head dim below the
//     width multiply zeros (a branch per tile there kept ptxas from
//     interleaving the products, 11-31% slower on an H100).
//   * The tensor cores round their float32 sums toward zero, not to
//     nearest: summed into one accumulator over all of a row's keys, P V
//     drifted with the keys, to 1.7e-5 of the 2e-5 contract at 16384 keys
//     on an H100 (tools/flash_f32.py --part errors). So a key tile's P V
//     is summed into a zeroed fragment and added to O by a float32 fma (O
//     = alpha O + P V), and in S = Q K^T the two products of a small half
//     sum in their own fragment (~2^-11 of S, whose rounding is then
//     negligible) and join S after the last k step: at most 2.4e-6 up to
//     32768 keys, flat in the keys.
//   * The grid puts heads innermost and runs q tiles from the last, so the
//     heaviest causal tiles start first. Key tiles that lie wholly above the
//     causal diagonal or outside the window of all rows of the block are
//     skipped, and a warp skips a tile that none of its rows sees: exact for
//     every row that sees a key (a masked tile adds exp(-2^30 - m) = 0, and
//     tiles before the row's first visible key are wiped by alpha =
//     exp(-2^30 - m) = 0, as in the contract). Masks are applied only in
//     tiles that hold a masked pair for one of the warp's rows. A row that
//     sees no key gets the contract's value in closed form: every reference
//     block adds exp(0) = 1 per key, so the output is the sum of v over all
//     tk keys divided by nk * block_k of the op's block_k argument
//     (empty_denom), from a second pass that runs only in blocks that hold
//     such rows.
//   * No split over keys: a row's result depends only on its own q, its
//     position, the keys and the masks, never on tq, B, H, the q tile or
//     other rows.
//   * Tiles by head-dim width (the Tiles traits below, each the fastest
//     that an H100 ran without spilling registers at D <= 128): D <= 64:
//     8 warps x 2 m-tiles (a 256-row q tile), 32-key tiles; D <= 128: 8
//     warps x 1 m-tile, 32-key tiles; D <= 256: 4 warps x 1 m-tile (the 16 x
//     256 float32 O accumulator of a warp takes 128 registers a lane),
//     32-key tiles. Larger tiles ran faster at D = 64 and 128 but spilled.
//
// With a non-null `lse` the kernel also writes each row's natural
// log-sum-exp of its scaled logits, m + log l, as float32 (B, H, Tq): the
// training forward saves it for the backward (csrc/flash_attention_bwd.cu).
// The serving path passes null and its output is unchanged.
//
// Inputs that cp.async cannot copy 16 bytes at a time (bfloat16, d % 4 !=
// 0, K or V off a 16-byte boundary) are loaded by plain loads into the
// same float32 tiles. Every entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMask = -1073741824.0f;  // -2^30
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// per head-dim width: warps per block, 16-row m-tiles per warp (the q tile
// is 16 * kWarps * kM rows) and keys per tile
template <int DMAX>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int kWarps = 8, kM = 2, kBK = 32;
};
template <>
struct Tiles<128> {
  static constexpr int kWarps = 8, kM = 1, kBK = 32;
};
template <>
struct Tiles<256> {
  static constexpr int kWarps = 4, kM = 1, kBK = 32;
};

// row strides in floats of the shared tiles of a head dim padded to dp
__host__ __device__ __forceinline__ int qk_stride(int dp) { return dp + ((8 - dp) & 31); }
__host__ __device__ __forceinline__ int v_stride(int dp) { return dp + ((4 - dp) & 15); }

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

// 2^x (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// float32 -> TF32 bits, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = big + small: big = tf32(a), small = a - big (exact), of which an
// mma.sync TF32 operand reads the top 19 bits (small truncated to TF32)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b, one m16n8k8 TF32 product with float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a B-fragment value as its TF32 halves; bfloat16 is exact in TF32 (no
// small half)
template <bool kExact>
__device__ __forceinline__ void halves(float x, uint32_t& big, uint32_t& small) {
  if constexpr (kExact) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    split(x, big, small);
  }
}

// c += a b in 3xTF32: a_small b_big, a_big b_small (none when b is exact),
// a_big b_big
template <bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma(c, as, bb);
  if constexpr (!kExactB) mma(c, ab, bs);
  mma(c, ab, bb);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keys [k0, k0 + BK) of one KV head (rows at src + (base + key * hkv) * d)
// into a float32 tile of row stride `stride`, zero past tk and past d up to
// dp; each warp takes every kWarps-th row. ASYNC: 16-byte cp.async (float
// with d % 4 == 0 and 16-byte aligned rows), else plain loads.
template <typename T, int kWarps, int BK, bool ASYNC>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int stride,
                                          int k0, int tk, int hkv, long long base, int d,
                                          int dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BK; r += kWarps) {
    const int key = k0 + r;
    const bool in = key < tk;
    const T* row = src + (base + (long long)(in ? key : 0) * hkv) * d;
    if constexpr (ASYNC) {
      static_assert(std::is_same<T, float>::value, "cp.async tiles are float32");
      for (int c = lane * 4; c < dp; c += 128) {
        const bool valid = in && c < d;
        cp_async16(dst + r * stride + c, valid ? row + c : src, valid);
      }
    } else {
#pragma unroll 1
      for (int c = lane; c < dp; c += 32)
        dst[r * stride + c] = in && c < d ? to_f32(row[c]) : 0.0f;
    }
  }
}

template <typename T, int DMAX, bool ASYNC>
__global__ void __launch_bounds__(Tiles<DMAX>::kWarps * 32)
flash_attention_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ lse, int tq, int tk, int h, int hkv, int d,
                              int causal, int window, int q_offset, float scale,
                              float empty_denom) {
  constexpr int kWarps = Tiles<DMAX>::kWarps;
  constexpr int kM = Tiles<DMAX>::kM;   // 16-row m-tiles a warp
  constexpr int kBQ = kWarps * 16 * kM;
  constexpr int BK = Tiles<DMAX>::kBK;
  constexpr int kNT = BK / 8;     // 8-key tiles of S, 8-key chunks of P V
  constexpr int kDT = DMAX / 8;   // 8-column tiles of O
  constexpr bool kExactKV = !std::is_same<T, float>::value;  // bf16 is exact in TF32
  static_assert(BK % 8 == 0, "8-key steps");

  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 7) & ~7;
  const int sqk = qk_stride(dp), sv = v_stride(dp);
  float* qs = smem;                // kBQ x sqk
  float* ks = qs + kBQ * sqk;      // stage s: ks + s * BK * sqk
  float* vs = ks + 2 * BK * sqk;   // stage s: vs + s * BK * sv

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bb = blockIdx.z;
  const int kvh = head / (h / hkv);
  const long long kv_base = (long long)bb * tk * hkv + kvh;

  // the scaled q tile, zero past tq and past d
  for (int r = warp; r < kBQ; r += kWarps) {
    const int t = i0 + r;
    const T* row = q + (((long long)bb * tq + (t < tq ? t : 0)) * h + head) * d;
    for (int c = lane; c < dp; c += 32)
      qs[r * sqk + c] = t < tq && c < d ? to_f32(row[c]) * scale : 0.0f;
  }

  // this lane's rows: w0 + 16 mt + g and w0 + 16 mt + g + 8 of the tile
  const int w0 = warp * 16 * kM;
  int qpos[kM][2];
  bool empty[kM][2], any_empty = false;
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = i0 + w0 + 16 * mt + g + 8 * i;
      qpos[mt][i] = q_offset + t;
      const int lo = window > 0 ? max(0, qpos[mt][i] - window + 1) : 0;
      const int hi = causal ? min(tk - 1, qpos[mt][i]) : tk - 1;
      empty[mt][i] = t < tq && lo > hi;
      any_empty |= empty[mt][i];
    }
  // the keys any row of the warp can see: [w_first, w_last]
  const int w_lo = q_offset + i0 + w0, w_hi = w_lo + 16 * kM - 1;
  const int w_first = window > 0 ? max(0, w_lo - window + 1) : 0;
  const int w_last = causal ? min(tk - 1, w_hi) : tk - 1;

  float m[kM][2], l[kM][2], acc[kM][kDT][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;
  }

  // the key tiles any row of this block can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + kBQ, tq) - 1;
  const int b_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int b_hi = causal ? min(tk - 1, q_hi) : tk - 1;
  const int t_first = b_lo / BK;
  const int t_last = b_hi >= b_lo ? b_hi / BK : t_first - 1;

  if (t_first <= t_last) {
    load_tile<T, kWarps, BK, ASYNC>(k, ks, sqk, t_first * BK, tk, hkv, kv_base, d, dp);
    load_tile<T, kWarps, BK, ASYNC>(v, vs, sv, t_first * BK, tk, hkv, kv_base, d, dp);
    if constexpr (ASYNC) cp_async_commit();
  }
  for (int kt = t_first; kt <= t_last; ++kt) {
    const int st = (kt - t_first) & 1;
    if (kt < t_last) {  // the next tile into the other stage, consumed at the end of the last pass
      load_tile<T, kWarps, BK, ASYNC>(k, ks + (st ^ 1) * BK * sqk, sqk, (kt + 1) * BK, tk, hkv,
                                      kv_base, d, dp);
      load_tile<T, kWarps, BK, ASYNC>(v, vs + (st ^ 1) * BK * sv, sv, (kt + 1) * BK, tk, hkv,
                                      kv_base, d, dp);
      if constexpr (ASYNC) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (ASYNC) {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and the q tile) visible to every warp
    const int k0 = kt * BK;
    // a tile that no row of the warp sees is skipped by the warp: its p
    // would be exp(-2^30 - m) = 0 once a row sees a key, and is wiped by
    // alpha = 0 until it does
    if (k0 <= w_last && k0 + BK - 1 >= w_first) {
      const float* kst = ks + st * BK * sqk;
      const float* vst = vs + st * BK * sv;

      // S = Q K^T: s[mt][j] holds (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, ...);
      // the products of a small half sum apart in sc, ~2^-11 of s, so that
      // the tensor cores' rounding toward zero of s falls on one product of
      // three
      float s[kM][kNT][4], sc[kM][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = sc[mt][j][e] = 0.0f;
      const float* qa = qs + (w0 + g) * sqk + 2 * t4;
      const float* kb = kst + g * sqk + 2 * t4;
#pragma unroll 2
      for (int kk = 0; kk < dp; kk += 8) {
        uint32_t ab[kM][4], as[kM][4];
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          const float2 x0 = *reinterpret_cast<const float2*>(qa + 16 * mt * sqk + kk);
          const float2 x1 = *reinterpret_cast<const float2*>(qa + (16 * mt + 8) * sqk + kk);
          split(x0.x, ab[mt][0], as[mt][0]);  // a0: row g, dim 2t
          split(x1.x, ab[mt][1], as[mt][1]);  // a1: row g + 8, dim 2t
          split(x0.y, ab[mt][2], as[mt][2]);  // a2: row g, dim 2t + 1
          split(x1.y, ab[mt][3], as[mt][3]);  // a3: row g + 8, dim 2t + 1
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // b0: key g, dim 2t; b1: key g, dim 2t + 1
          const float2 y = *reinterpret_cast<const float2*>(kb + 8 * j * sqk + kk);
          uint32_t bb[2], bs[2];
          halves<kExactKV>(y.x, bb[0], bs[0]);
          halves<kExactKV>(y.y, bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            mma(sc[mt][j], as[mt], bb);
            if constexpr (!kExactKV) mma(sc[mt][j], ab[mt], bs);
            mma(s[mt][j], ab[mt], bb);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] += sc[mt][j][e];

      const bool full = k0 + BK <= tk && (!causal || k0 + BK - 1 <= w_lo) &&
                        (window <= 0 || k0 > w_hi - window);
      if (!full) {
#pragma unroll
        for (int mt = 0; mt < kM; ++mt)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + 2 * t4 + (e & 1);
              const int p = qpos[mt][e >> 1];
              const bool ok =
                  key < tk && (!causal || key <= p) && (window <= 0 || key > p - window);
              if (!ok) s[mt][j][e] = kMask;
            }
      }

      // online softmax on the fragments: rows g (i = 0) and g + 8 (i = 1)
      float alpha[kM][2];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kNT; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * i], s[mt][j][2 * i + 1]));
          const float m_new = fmaxf(m[mt][i], quad_max(mx));
          alpha[mt][i] = fast_exp2((m[mt][i] - m_new) * kLog2e);
          m[mt][i] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 2 * i; e < 2 * i + 2; ++e) {
              s[mt][j][e] = fast_exp2((s[mt][j][e] - m_new) * kLog2e);
              sum += s[mt][j][e];
            }
          l[mt][i] = l[mt][i] * alpha[mt][i] + quad_sum(sum);
        }

      // P as A fragments: keys 8c + 2t and 8c + 2t + 1 are columns t and t + 4
      uint32_t pb[kM][kNT][4], ps[kM][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          split(s[mt][c][0], pb[mt][c][0], ps[mt][c][0]);  // a0: row g, key 2t
          split(s[mt][c][2], pb[mt][c][1], ps[mt][c][1]);  // a1: row g + 8, key 2t
          split(s[mt][c][1], pb[mt][c][2], ps[mt][c][2]);  // a2: row g, key 2t + 1
          split(s[mt][c][3], pb[mt][c][3], ps[mt][c][3]);  // a3: row g + 8, key 2t + 1
        }
      // O = alpha O + P V, one 8-column tile of O at a time: the tile's
      // keys are summed on the tensor cores into a zeroed fragment, which
      // is added to O in float32 (round to nearest), so that the tensor
      // cores' rounding of their float32 sums, toward zero, accumulates
      // over the BK keys of a tile and not over all of a row's keys
      const float* vb = vst + 2 * t4 * sv + g;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        // columns past dp get zeros (their products are never stored),
        // with no branch
        const int nn = 8 * n < dp ? n : 0;
        float pv[kM][4];
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) pv[mt][0] = pv[mt][1] = pv[mt][2] = pv[mt][3] = 0.0f;
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          // b0: key 8c + 2t, dim g; b1: key 8c + 2t + 1, dim g
          uint32_t bb[2], bs[2];
          halves<kExactKV>(vb[8 * c * sv + 8 * nn], bb[0], bs[0]);
          halves<kExactKV>(vb[(8 * c + 1) * sv + 8 * nn], bb[1], bs[1]);
          if (8 * n >= dp) bb[0] = bb[1] = bs[0] = bs[1] = 0u;
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) mma3<kExactKV>(pv[mt], pb[mt][c], ps[mt][c], bb, bs);
        }
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          acc[mt][n][0] = fmaf(acc[mt][n][0], alpha[mt][0], pv[mt][0]);
          acc[mt][n][1] = fmaf(acc[mt][n][1], alpha[mt][0], pv[mt][1]);
          acc[mt][n][2] = fmaf(acc[mt][n][2], alpha[mt][1], pv[mt][2]);
          acc[mt][n][3] = fmaf(acc[mt][n][3], alpha[mt][1], pv[mt][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // rows with no visible key: the sum of v over all keys / empty_denom
  if (__syncthreads_or(any_empty)) {
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!empty[mt][i]) continue;
        l[mt][i] = empty_denom;
#pragma unroll
        for (int n = 0; n < kDT; ++n) acc[mt][n][2 * i] = acc[mt][n][2 * i + 1] = 0.0f;
      }
    for (int k0 = 0; k0 < tk; k0 += BK) {
      __syncthreads();
      load_tile<T, kWarps, BK, false>(v, vs, sv, k0, tk, hkv, kv_base, d, dp);
      __syncthreads();
      if (!any_empty) continue;
      for (int r = 0; r < BK; ++r) {
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          if (8 * n >= dp) continue;
          const float x0 = vs[r * sv + 8 * n + 2 * t4], x1 = vs[r * sv + 8 * n + 2 * t4 + 1];
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!empty[mt][i]) continue;
              acc[mt][n][2 * i] += x0;
              acc[mt][n][2 * i + 1] += x1;
            }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = i0 + w0 + 16 * mt + g + 8 * i;
      if (t >= tq) continue;
      // the row's natural log-sum-exp for the backward (m and l are shared
      // by the quad)
      if (lse != nullptr && t4 == 0)
        lse[((long long)bb * h + head) * tq + t] = m[mt][i] + logf(l[mt][i]);
      const float den = fmaxf(l[mt][i], 1e-30f);
      T* row = o + (((long long)bb * tq + t) * h + head) * d;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < d) row[col] = from_f32<T>(acc[mt][n][2 * i] / den);
        if (col + 1 < d) row[col + 1] = from_f32<T>(acc[mt][n][2 * i + 1] / den);
      }
    }
}

template <typename T, int DMAX, bool ASYNC>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int tq, int tk, int h, int hkv, int d, int causal, int window, int q_offset,
                     double scale, double empty_denom, void* stream) {
  constexpr int kWarps = Tiles<DMAX>::kWarps, BK = Tiles<DMAX>::kBK;
  constexpr int kBQ = kWarps * 16 * Tiles<DMAX>::kM;
  if ((tq + kBQ - 1) / kBQ > 65535) return cudaErrorInvalidValue;
  const int dp = (d + 7) & ~7;
  // the q tile and two stages of K and V
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * BK) * qk_stride(dp) +
                                       (size_t)2 * BK * v_stride(dp));
  auto kernel = flash_attention_tf32x3_kernel<T, DMAX, ASYNC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)h, (unsigned)((tq + kBQ - 1) / kBQ), (unsigned)b);
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, tq, tk, h, hkv, d, causal, window,
      q_offset, (float)scale, (float)empty_denom);
  return cudaGetLastError();
}

// cp.async for float32 rows it can copy 16 bytes at a time, else plain loads
template <typename T, int DMAX>
cudaError_t launch_a(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int tq, int tk, int h, int hkv, int d, int causal, int window, int q_offset,
                     double scale, double empty_denom, void* stream) {
  if constexpr (std::is_same<T, float>::value) {
    const bool aligned = d % 4 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
    if (aligned)
      return launch_d<T, DMAX, true>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window,
                                     q_offset, scale, empty_denom, stream);
  }
  return launch_d<T, DMAX, false>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window,
                                  q_offset, scale, empty_denom, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int tq,
                   int tk, int h, int hkv, int d, int causal, int window, int q_offset,
                   double scale, double empty_denom, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 ||
      b > 65535 || q_offset < 0)
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_a<T, 64>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                           empty_denom, stream);
  if (d <= 128)
    return launch_a<T, 128>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                            empty_denom, stream);
  if (d <= 256)
    return launch_a<T, 256>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                            empty_denom, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

cudaError_t repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int b, int tq, int tk, int h, int hkv, int d,
                                      int causal, int window, int q_offset, double scale,
                                      double empty_denom, void* stream) {
  return launch<float>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset, scale,
                       empty_denom, stream);
}

cudaError_t repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int b, int tq, int tk, int h, int hkv, int d,
                                       int causal, int window, int q_offset, double scale,
                                       double empty_denom, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset,
                               scale, empty_denom, stream);
}

}  // extern "C"
