// Flash-attention backward for NVIDIA Hopper (sm_90a) on the tensor cores in
// float32 accuracy, the `tf32x3` route: the gradients dq, dk and dv of
// grouped-query self-attention, float32 and bfloat16 inputs in (B, T, H, D)
// layout, head dim up to 256. The wrapper's flash_bwd_route sends bfloat16
// with a head dim that is a multiple of 8 to csrc/flash_attention_bwd_sm90.cu
// (route `sm90`) and everything else here, the forward's tf32x3 inputs:
// float32 (the f32 training twin) and bfloat16 head dims that TMA cannot
// stride (d % 8 != 0).
//
// Replaces no Pallas kernel: the reference has no backward kernel (nothing
// under src/repro/kernels defines a custom_vjp), and its training gradient
// is JAX's derivative of the jnp ops of repro.kernels.ref.mha_blocked,
// reached from src/repro/models/attention.py:104. The forward kernels fill
// their output through a raw pointer, which autograd cannot differentiate,
// so the port's training step needs this backward. Its plain version is
// repro_torch.kernels.ref.mha_blocked_grad.
//
// What it computes, in the FlashAttention-2 manner, from the forward's
// output o and its row log-sum-exp lse (float32 (B, H, T)): with s = scale
// (q . k) and p = exp(s - lse) on the pairs the masks keep (causal kpos <=
// qpos, window kpos > qpos - window) and 0 elsewhere,
//   delta_i = sum_c dO_ic o_ic,   dS = p (dO . v - delta_i),
//   dv = sum_i p dO,   dk = scale sum_i dS q,   dq = scale sum_j dS k,
// with dk and dv summed over the H / Hkv query heads of their KV head.
// Scale multiplies the float32 dot q . k and the finished dk and dq, where
// the contract multiplies q before the dot: the same value to a float32
// rounding, and bfloat16 q stays exact in TF32. Only self-attention: Tq =
// Tk and q_offset 0, where every row sees its own key (the wrapper refuses
// other shapes).
//
// What bounds it: operations. The training shape (2, 2048, 32, 4, 64)
// causal does five products of 2 * 64 flops over 2 * 32 * 2,098,176
// visible pairs: 85.9 GFLOP, 1.28 ms at the 67 TFLOP/s float32 CUDA-core
// peak. One TF32 product keeps 11 bits of each operand and misses the
// op's 1e-4 by far, so each float32 operand is split as the forward's
// (csrc/flash_attention.cu): a = a_big + a_small, a_big = tf32(a) by
// cvt.rna's rule, a * b taken as a_small b_big + a_big b_small + a_big
// b_big (3xTF32). That is 257.7 TF32-GFLOP, 0.521 ms at the 494.7 TFLOP/s
// dense TF32 peak; the seven products this design does (S and dP are
// computed twice, no atomics) take 361 TF32-GFLOP, 1.15 ms at the ~314
// TFLOP/s that mma.sync m16n8k8 TF32 reached on an H100
// (tools/mma_rate.py), against 25 MB of inputs and outputs (0.0075 ms at
// 3.35 TB/s). bfloat16 q, k, v and dO are exact in TF32: every product is
// one mma, with P and dS rounded to TF32 (11 bits, where the sm90 route
// rounds them to bfloat16's 8; tests/test_torch_kernels_flash_bwd_tf32.py
// shows that moves no gradient by more than a bfloat16 rounding).
//
// What the design does about it: every product runs on the tensor cores as
// mma.sync.m16n8k8 TF32 with float32 accumulators, the schedule of the sm90
// backward (csrc/flash_attention_bwd_sm90.cu) on the forward's fragments.
//   * Fragments (lane = 4 g + t): A holds rows g and g + 8, columns t and t
//     + 4; B rows t and t + 4, column g; C rows g and g + 8, columns 2t and
//     2t + 1. Products over the head dim permute its k order as the forward
//     does (A columns t, t + 4 and B rows t, t + 4 are dims 2t, 2t + 1), so
//     each fragment is one 8-byte load. The C fragment of a product over
//     dims is the A fragment of the next product, over its columns, when A
//     columns t and t + 4 are read as C columns 2t and 2t + 1 (a0 = c0, a1
//     = c2, a2 = c1, a3 = c3), the forward's S -> P.
//   * flash_bwd_dkdv_tf32x3_kernel: a block owns a tile of keys of one KV
//     head and walks the query tiles that see its keys for a run of its
//     group's heads. A query step is four products: S^T = K Q^T and dP^T =
//     V dO^T, keys as C rows; P^T = exp2(S^T scale log2(e) - lse log2(e))
//     and dS^T = P^T (dP^T - delta) in registers, lse and delta per C
//     column; dV += P^T dO, then dK += dS^T Q, P^T and dS^T as A fragments.
//     A warp owns 16 keys and 64 columns of dK and dV (64 float32
//     accumulators a lane at every width): at D = 128 (256) two (four) warps
//     share 16 keys, each sums S^T and dP^T over its part of the dims, and
//     they trade the partial sums through shared memory behind a named
//     barrier for the slice, adding them in order of the dims, so no product
//     is done twice. K and V come once; Q, dO, lse and delta through two
//     stages of shared memory by cp.async.
//   * flash_bwd_dq_tf32x3_kernel: a block owns a 64-row query tile of one
//     head, a warp 16 rows, and walks the key tiles its rows see, K and V
//     through two stages: S = Q K^T, dP = dO V^T, dS, dQ += dS K. The last
//     query tiles, the heaviest under the causal mask, start first.
//   * The reused C -> A fragments fix B's rows: queries (keys) 2t and 2t +
//     1 of each 8-row step at column g, 4-byte loads, where the first
//     products read the same tile as 8-byte loads at rows g. No row stride
//     serves both without bank conflicts, so column j of each 8-column C
//     tile holds row perm8(j) = j ^ (j >> 2) of its 8-row group: with the
//     forward's qk_stride (8 mod 32 floats) the 8-byte loads of rows
//     perm8(g) and the 4-byte loads of rows perm8(2t), perm8(2t + 1) each
//     hit 32 banks. Every tile takes that stride.
//   * The tensor cores round their float32 sums toward zero. Each query
//     step's P^T dO and dS^T Q is summed into zeroed fragments and added to
//     dV and dK by a float32 add (round to nearest), and each key step's dS
//     K to dQ likewise, so the rounding does not grow with T; in every
//     product the two products of a small half sum in their own fragment
//     (~2^-11 of the value, its rounding negligible) and join the big one
//     at the end, as the forward's S. The separate fragments also halve the
//     chains of dependent mma.sync (8% off the training shape's time on an
//     H100).
//   * GQA and the causal imbalance: the dk/dv grid cuts a KV head's group
//     into `splits` runs of heads (the wrapper's bwd_tf32x3_splits); with
//     more than one, each run writes float32 partials (splits, B, T, Hkv,
//     D) and flash_bwd_sum_tf32x3_kernel adds them in run order.
//   * flash_bwd_delta_tf32x3_kernel: delta, a warp a row.
//   * Tiles that hold a masked pair for one of a warp's rows test each pair;
//     a warp skips a step none of its pairs sees (exact: a skipped step
//     would add a zero fragment). No floating-point atomics: a second call
//     repeats bit for bit.
//   * Tiles by head-dim width (BwdTiles): dk/dv query steps of 16 rows over
//     64-key tiles (32 at D = 256), dq key steps of 32 (D <= 64) or 16 over
//     64-row tiles. ptxas, left to its own register targets, spilled some
//     dk/dv instantiations at every width on an H100's toolkit (CUDA 12.9);
//     the dk/dv kernel's __launch_bounds__ asks for two resident blocks at
//     D <= 64 and one above: of the settings timed (steps of 16, 24 and 32
//     rows; one, two or three blocks; __maxnreg__ 184 to 255;
//     --register-usage-level 0 to 10), the one under which no
//     instantiation spills.
//
// Inputs that cp.async cannot copy 16 bytes at a time (bfloat16, d % 4 !=
// 0, a tensor off a 16-byte boundary) are loaded by plain loads into the
// same float32 tiles. Every entry point launches on the given stream,
// allocates nothing (the caller's float32 scratch holds delta and the
// partials) and returns cudaGetLastError() after the launches, or the first
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;  // the delta pass and the split sum
constexpr int kDqRows = 64;       // query rows of a dq tile

// per head-dim width: the dk/dv kernel's warps (16 keys each; kSplitD warps
// share a key slice, each summing S^T and dP^T over 1 / kSplitD of the dims
// and owning 64 of dK's and dV's columns), its query rows a step, keys a
// tile (16 kKvWarps / kSplitD) and the blocks its __launch_bounds__ asks to
// be resident on a SM; the dq kernel's key rows a step
template <int DMAX>
struct BwdTiles;
template <>
struct BwdTiles<64> {
  static constexpr int kKvWarps = 4, kSplitD = 1, kBQ = 16, kBK = 64, kMinBlocks = 2, kBKq = 32;
};
template <>
struct BwdTiles<128> {
  static constexpr int kKvWarps = 8, kSplitD = 2, kBQ = 16, kBK = 64, kMinBlocks = 1, kBKq = 16;
};
template <>
struct BwdTiles<256> {
  static constexpr int kKvWarps = 8, kSplitD = 4, kBQ = 16, kBK = 32, kMinBlocks = 1, kBKq = 16;
};
constexpr int kQWarps = kDqRows / 16;  // the dq kernel's warps, 16 rows each

// row stride in floats of every shared tile of a head dim padded to dp (the
// forward's qk_stride)
__host__ __device__ __forceinline__ int qk_stride(int dp) { return dp + ((8 - dp) & 31); }

// the row of its 8-row group that column j of an 8-column C tile holds
__device__ __forceinline__ int perm8(int j) { return j ^ (j >> 2); }

// x, opaque to the compiler: the tile offsets derived from it in a step
// are recomputed there, not hoisted out of the step loop (one register
// each for every unrolled tile). Without it ptxas (CUDA 12.9) spilled the
// dq kernel's float32 plain-load instantiation at D <= 64.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

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

// x as TF32 halves: big = tf32(x) and, in 3xTF32 (kSplit), small = x - big
// (exact), of which an mma.sync TF32 operand reads the top 19 bits; without
// kSplit x is taken as big alone (exact for bfloat16 values)
template <bool kSplit>
__device__ __forceinline__ void halves(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = kSplit ? __float_as_uint(x - __uint_as_float(big)) : 0u;
}

// c += a b, one m16n8k8 TF32 product with float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

__device__ __forceinline__ bool visible(int qi, int kj, int t, int causal, int window) {
  return qi < t && kj < t && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// rows [r0, r0 + R) of one head of a (B, T, heads, d) tensor (row r at src
// + (base + r * heads) * d) into a float32 tile of row stride `stride`,
// zero past t and past d up to dp; each warp takes every kWarps-th row.
// ASYNC: 16-byte cp.async (float with d % 4 == 0 and 16-byte aligned
// rows), else plain loads.
template <typename T, int kWarps, int R, bool ASYNC>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst, int stride, int r0,
                                          int t, int heads, long long base, int d, int dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const int row = r0 + r;
    const bool in = row < t;
    const T* p = src + (base + (long long)(in ? row : 0) * heads) * d;
    if constexpr (ASYNC) {
      static_assert(std::is_same<T, float>::value, "cp.async tiles are float32");
      for (int c = lane * 4; c < dp; c += 128) {
        const bool valid = in && c < d;
        cp_async16(dst + r * stride + c, valid ? p + c : src, valid);
      }
    } else {
#pragma unroll 1
      for (int c = lane; c < dp; c += 32) dst[r * stride + c] = in && c < d ? to_f32(p[c]) : 0.0f;
    }
  }
}

// c[j] (rows g and g + 8 of A, C columns of 8-row group j of B) = A B^T
// over the first dp dims: a points at A's row g, column 2t; b at B's row
// perm8(g), column 2t. The products of a small half sum apart and join c
// after the last k step.
template <int N, bool kSplit>
__device__ __forceinline__ void dot_rows(float (&c)[N][4], const float* a, const float* b,
                                         int stride, int dp) {
  float cs[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = cs[j][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < dp; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * stride + kk);
    uint32_t ab[4], as[4];
    halves<kSplit>(x0.x, ab[0], as[0]);  // a0: row g, dim 2t
    halves<kSplit>(x1.x, ab[1], as[1]);  // a1: row g + 8, dim 2t
    halves<kSplit>(x0.y, ab[2], as[2]);  // a2: row g, dim 2t + 1
    halves<kSplit>(x1.y, ab[3], as[3]);  // a3: row g + 8, dim 2t + 1
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // b0: row perm8(g) of group j, dim 2t; b1: dim 2t + 1
      const float2 y = *reinterpret_cast<const float2*>(b + 8 * j * stride + kk);
      uint32_t bb[2], bs[2];
      halves<kSplit>(y.x, bb[0], bs[0]);
      halves<kSplit>(y.y, bb[1], bs[1]);
      if constexpr (kSplit) {
        mma(cs[j], as, bb);
        mma(cs[j], ab, bs);
      }
      mma(c[j], ab, bb);
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
  }
}

// C fragments of N 8-column tiles as the A fragments of a product over
// their columns: columns t and t + 4 of k-step j are C columns 2t and 2t + 1
template <int N, bool kSplit>
__device__ __forceinline__ void as_a(const float (&c)[N][4], uint32_t (&big)[N][4],
                                     uint32_t (&small)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    halves<kSplit>(c[j][0], big[j][0], small[j][0]);  // a0: row g, column 2t
    halves<kSplit>(c[j][2], big[j][1], small[j][1]);  // a1: row g + 8, column 2t
    halves<kSplit>(c[j][1], big[j][2], small[j][2]);  // a2: row g, column 2t + 1
    halves<kSplit>(c[j][3], big[j][3], small[j][3]);  // a3: row g + 8, column 2t + 1
  }
}

// acc[n] += A B over the kNK k-steps of 8 rows, for the kNT 8-column tiles
// of B from column cb: A's fragments (C fragments made A by as_a), B's rows
// b + 8 k stride (b0, at row qc of the k-step's 8 rows) and b + 8 k stride
// + other (b1, row qc ^ 1), column 8 n + g. Each tile's k-steps sum on the
// tensor cores into zeroed fragments, the small halves' products apart,
// added to acc in float32 (round to nearest). Columns past dp multiply
// zeros (their products are never stored), with no branch.
template <int kNK, int kNT, bool kSplit>
__device__ __forceinline__ void accumulate(float (&acc)[kNT][4], const uint32_t (&ab)[kNK][4],
                                           const uint32_t (&as)[kNK][4], const float* b,
                                           int other, int stride, int cb, int dp) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const bool live = cb + 8 * n < dp;
    const int nn = live ? n : 0;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kNK; ++k) {
      const int at = 8 * k * stride + 8 * nn;
      uint32_t bb[2], bs[2];
      halves<kSplit>(b[at], bb[0], bs[0]);
      halves<kSplit>(b[at + other], bb[1], bs[1]);
      if (!live) bb[0] = bb[1] = bs[0] = bs[1] = 0u;
      if constexpr (kSplit) {
        mma(cs, as[k], bb);
        mma(cs, ab[k], bs);
      }
      mma(c, ab[k], bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e] + cs[e];
  }
}

// delta[(b, head, i)] = sum_c dout[b, i, head, c] o[b, i, head, c], a warp
// a row of the (B * T * H, d) view
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_delta_tf32x3_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                              float* __restrict__ delta, long long rows, int t, int h, int d) {
  const long long row = ((long long)blockIdx.x * kRowThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* po = o + row * d;
  const T* pd = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(pd[c]), to_f32(po[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const int head = (int)(row % h);
    const long long bi = row / h;  // b * t + i
    const int i = (int)(bi % t);
    delta[((bi / t) * h + head) * t + i] = s;
  }
}

// dk and dv of key tile blockIdx.y of KV head blockIdx.x / splits, batch row
// blockIdx.z, over query heads run blockIdx.x % splits of its group
template <typename T, int DMAX, bool ASYNC>
__global__ void __launch_bounds__(BwdTiles<DMAX>::kKvWarps * 32, BwdTiles<DMAX>::kMinBlocks)
flash_bwd_dkdv_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dk_part,
                             float* __restrict__ dv_part, int b, int t, int h, int hkv, int d,
                             int causal, int window, int splits, float scale_log2, float scale) {
  using L = BwdTiles<DMAX>;
  constexpr int kWarps = L::kKvWarps;
  constexpr int kKeyWarps = kWarps / L::kSplitD;  // warps along the keys, 16 keys each
  constexpr int kBK = L::kBK;
  constexpr int BQ = L::kBQ;
  constexpr int kNQ = BQ / 8;                // 8-query tiles of S^T: k-steps of dV and dK
  constexpr int kCols = DMAX / L::kSplitD;   // dK and dV columns a warp owns
  constexpr int kNT = kCols / 8;
  constexpr bool kSplit = std::is_same<T, float>::value;  // bfloat16 is exact in TF32
  static_assert(16 * kKeyWarps == kBK && kCols == 64, "a warp owns 16 keys and 64 columns");

  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 7) & ~7;
  const int sqk = qk_stride(dp);
  float* ks = smem;                  // kBK x sqk
  float* vs = ks + kBK * sqk;        // kBK x sqk
  float* qs = vs + kBK * sqk;        // stage s: qs + s BQ sqk
  float* dos = qs + 2 * BQ * sqk;    // stage s: dos + s BQ sqk
  float* stat = dos + 2 * BQ * sqk;  // stage s: lse log2(e) at stat + 2 s BQ, delta BQ further
  float* xs = stat + 4 * BQ;         // with kSplitD > 1: warp w's partial S^T, dP^T at + 8 kNQ 32 w

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = warp % kKeyWarps, cw = warp / kKeyWarps;
  const int kvh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int j0 = blockIdx.y * kBK;  // key tile 0 sees the most query tiles: it starts first
  const int bb = blockIdx.z;
  const int group = h / hkv, per = group / splits;
  const int head0 = kvh * group + split * per;
  const long long kv_base = (long long)bb * t * hkv + kvh;

  // the query tiles that see a key of this tile, for each of `per` heads
  const int j_hi = min(j0 + kBK, t) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 && window <= t ? min(t - 1, j_hi + window - 1) : t - 1;
  const int qt_first = i_lo / BQ;
  const int n_q = i_hi / BQ - qt_first + 1;
  const int n_iter = per * n_q;

  // Q, dO, lse log2(e) and delta of step n (head n / n_q, query tile n %
  // n_q) into stage s
  auto load_step = [&](int s, int n) {
    const int head = head0 + n / n_q;
    const int i0 = (qt_first + n % n_q) * BQ;
    const long long q_base = (long long)bb * t * h + head;
    load_rows<T, kWarps, BQ, ASYNC>(q, qs + s * BQ * sqk, sqk, i0, t, h, q_base, d, dp);
    load_rows<T, kWarps, BQ, ASYNC>(dout, dos + s * BQ * sqk, sqk, i0, t, h, q_base, d, dp);
    const long long row = ((long long)bb * h + head) * t + i0;
    for (int r = threadIdx.x; r < BQ; r += kWarps * 32) {
      const bool in = i0 + r < t;
      stat[2 * s * BQ + r] = in ? lse[row + r] * kLog2e : 0.0f;
      stat[2 * s * BQ + BQ + r] = in ? delta[row + r] : 0.0f;
    }
  };

  load_rows<T, kWarps, kBK, ASYNC>(k, ks, sqk, j0, t, hkv, kv_base, d, dp);
  load_rows<T, kWarps, kBK, ASYNC>(v, vs, sqk, j0, t, hkv, kv_base, d, dp);
  load_step(0, 0);
  if constexpr (ASYNC) cp_async_commit();

  // this lane's keys: key0 and key0 + 8; the queries of its C columns 2t and
  // 2t + 1 in each 8-query tile: qc and qc ^ 1
  const int kw_lo = j0 + 16 * kw, kw_hi = kw_lo + 15;
  const int key0 = kw_lo + g;
  const int qc = perm8(2 * t4);
  const int cb = cw * kCols;  // this warp's first column of dK and dV
  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int n = 0; n < n_iter; ++n) {
    const int st = n & 1;
    if (n + 1 < n_iter) {  // the next step into the other stage, consumed at the end of the last pass
      load_step(st ^ 1, n + 1);
      if constexpr (ASYNC) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (ASYNC) {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step (and K, V) visible to every warp
    const int i0 = (qt_first + n % n_q) * BQ;
    // a step whose queries see none of the warp's keys adds nothing: skipped
    const bool seen = kw_lo < t && (!causal || i0 + BQ - 1 >= kw_lo) &&
                      (window <= 0 || i0 - kw_hi < window);
    if (seen) {
      const int sq = opaque(sqk), dpo = opaque(dp);
      const float* qst = qs + st * BQ * sq;
      const float* dost = dos + st * BQ * sq;
      const float* ls = stat + 2 * st * BQ;
      const float* dl = ls + BQ;

      // S^T = K Q^T and dP^T = V dO^T: keys key0 and key0 + 8 in rows,
      // column 2t + e of tile j is query 8j + perm8(2t + e)
      float s[kNQ][4], dpt[kNQ][4];
      const int part = ((dpo >> 3) + L::kSplitD - 1) / L::kSplitD * 8;  // dims a warp sums
      const int d0 = min(dpo, cw * part), nd = min(dpo, d0 + part) - d0;
      const int arow = (16 * kw + g) * sq + 2 * t4 + d0;
      const int brow = perm8(g) * sq + 2 * t4 + d0;
      dot_rows<kNQ, kSplit>(s, ks + arow, qst + brow, sq, nd);
      dot_rows<kNQ, kSplit>(dpt, vs + arow, dost + brow, sq, nd);
      if constexpr (L::kSplitD > 1) {
        // the warps of a key slice trade their partial sums (a named barrier
        // for the slice: every warp of it takes this branch) and add them in
        // order of their dims
        float* mine = xs + warp * 8 * kNQ * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[(4 * j + e) * 32] = s[j][e];
            mine[(4 * kNQ + 4 * j + e) * 32] = dpt[j][e];
            s[j][e] = dpt[j][e] = 0.0f;
          }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kw), "r"(32 * L::kSplitD) : "memory");
#pragma unroll
        for (int c = 0; c < L::kSplitD; ++c) {
          const float* theirs = xs + (c * kKeyWarps + kw) * 8 * kNQ * 32 + lane;
#pragma unroll
          for (int j = 0; j < kNQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[j][e] += theirs[(4 * j + e) * 32];
              dpt[j][e] += theirs[(4 * kNQ + 4 * j + e) * 32];
            }
        }
      }

      // P^T and dS^T, in place; per-column lse and delta
      const bool full = i0 + BQ <= t && kw_hi < t && (!causal || kw_hi <= i0) &&
                        (window <= 0 || i0 + BQ - 1 - kw_lo < window);
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + (qc ^ (e & 1));
          float p = fast_exp2(fmaf(s[j][e], scale_log2, -ls[col]));
          if (!full && !visible(i0 + col, key0 + 8 * (e >> 1), t, causal, window)) p = 0.0f;
          s[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl[col]);
        }
      // dV += P^T dO, then dK += dS^T Q (one A fragment live at a time): B
      // rows qc and qc ^ 1 of each k-step's 8 queries, this warp's columns
      const int other = (qc ^ 1) * sq - qc * sq;
      uint32_t ab[kNQ][4], as[kNQ][4];
      as_a<kNQ, kSplit>(s, ab, as);
      accumulate<kNQ, kNT, kSplit>(dv_acc, ab, as, dost + qc * sq + cb + g, other, sq, cb, dpo);
      as_a<kNQ, kSplit>(dpt, ab, as);
      accumulate<kNQ, kNT, kSplit>(dk_acc, ab, as, qst + qc * sq + cb + g, other, sq, cb, dpo);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // dk takes its scale; one run writes the gradients, several write float32
  // partials (splits, B, T, Hkv, D)
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int key = key0 + 8 * ri;
    if (key >= t) continue;
    const long long at = ((long long)bb * t + key) * hkv * d + (long long)kvh * d;
    const long long part = (long long)split * b * t * hkv * d + at;
#pragma unroll
    for (int n2 = 0; n2 < kNT; ++n2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cb + 8 * n2 + 2 * t4 + e;
        if (col >= d) continue;
        const float gk = dk_acc[n2][2 * ri + e] * scale, gv = dv_acc[n2][2 * ri + e];
        if (splits == 1) {
          dk[at + col] = from_f32<T>(gk);
          dv[at + col] = from_f32<T>(gv);
        } else {
          dk_part[part + col] = gk;
          dv_part[part + col] = gv;
        }
      }
  }
}

// dk and dv from the partials of `splits` runs of heads, added in run order
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_sum_tf32x3_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                            T* __restrict__ dk, T* __restrict__ dv, long long n, int splits) {
  const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n) return;
  float sk = 0.0f, sv = 0.0f;
  for (int s = 0; s < splits; ++s) {
    sk += dk_part[s * n + i];
    sv += dv_part[s * n + i];
  }
  dk[i] = from_f32<T>(sk);
  dv[i] = from_f32<T>(sv);
}

// dq of query tile (gridDim.y - 1 - blockIdx.y) of head blockIdx.x, batch
// row blockIdx.z, over the key tiles its rows see
template <typename T, int DMAX, bool ASYNC>
__global__ void __launch_bounds__(kQWarps * 32)
flash_bwd_dq_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int t, int h, int hkv, int d, int causal,
                           int window, float scale_log2, float scale) {
  constexpr int BK = BwdTiles<DMAX>::kBKq;
  constexpr int kNK = BK / 8;  // 8-key tiles of S: k-steps of dQ
  constexpr int kNT = DMAX / 8;
  constexpr bool kSplit = std::is_same<T, float>::value;

  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 7) & ~7;
  const int sqk = qk_stride(dp);
  float* qs = smem;                  // kDqRows x sqk
  float* dos = qs + kDqRows * sqk;   // kDqRows x sqk
  float* ks = dos + kDqRows * sqk;   // stage s: ks + s BK sqk
  float* vs = ks + 2 * BK * sqk;     // stage s: vs + s BK sqk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int head = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int bb = blockIdx.z;
  const int kvh = head / (h / hkv);
  const long long q_base = (long long)bb * t * h + head;
  const long long kv_base = (long long)bb * t * hkv + kvh;

  // the key tiles the tile's rows see
  const int i_hi = min(i0 + kDqRows, t) - 1;
  const int j_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int j_hi = causal ? i_hi : t - 1;
  const int kt_first = j_lo / BK;
  const int n_k = j_hi / BK - kt_first + 1;

  load_rows<T, kQWarps, kDqRows, ASYNC>(q, qs, sqk, i0, t, h, q_base, d, dp);
  load_rows<T, kQWarps, kDqRows, ASYNC>(dout, dos, sqk, i0, t, h, q_base, d, dp);
  load_rows<T, kQWarps, BK, ASYNC>(k, ks, sqk, kt_first * BK, t, hkv, kv_base, d, dp);
  load_rows<T, kQWarps, BK, ASYNC>(v, vs, sqk, kt_first * BK, t, hkv, kv_base, d, dp);
  if constexpr (ASYNC) cp_async_commit();

  // this lane's rows: r0 and r0 + 8 of the tile; the keys of its C columns
  // 2t and 2t + 1 in each 8-key tile: kc and kc ^ 1
  const int r0 = 16 * warp + g;
  const int qw_lo = i0 + 16 * warp, qw_hi = qw_lo + 15;
  const int kc = perm8(2 * t4);
  float l2[2], de[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int i = i0 + r0 + 8 * ri;
    const long long at = ((long long)bb * h + head) * t + i;
    l2[ri] = i < t ? lse[at] * kLog2e : 0.0f;
    de[ri] = i < t ? delta[at] : 0.0f;
  }
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j < n_k; ++j) {
    const int st = j & 1;
    const int k0 = (kt_first + j) * BK;
    if (j + 1 < n_k) {
      load_rows<T, kQWarps, BK, ASYNC>(k, ks + (st ^ 1) * BK * sqk, sqk, k0 + BK, t, hkv, kv_base,
                                       d, dp);
      load_rows<T, kQWarps, BK, ASYNC>(v, vs + (st ^ 1) * BK * sqk, sqk, k0 + BK, t, hkv, kv_base,
                                       d, dp);
      if constexpr (ASYNC) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (ASYNC) {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, dO) visible to every warp
    const bool seen = qw_lo < t && (!causal || k0 <= qw_hi) &&
                      (window <= 0 || qw_lo - (k0 + BK - 1) < window);
    if (seen) {
      const int sq = opaque(sqk), dpo = opaque(dp);
      const float* kst = ks + st * BK * sq;
      const float* vst = vs + st * BK * sq;

      // S = Q K^T and dP = dO V^T: rows r0 and r0 + 8, column 2t + e of
      // tile c is key 8c + perm8(2t + e)
      float s[kNK][4], dpv[kNK][4];
      const int arow = r0 * sq + 2 * t4;
      const int brow = perm8(g) * sq + 2 * t4;
      dot_rows<kNK, kSplit>(s, qs + arow, kst + brow, sq, dpo);
      dot_rows<kNK, kSplit>(dpv, dos + arow, vst + brow, sq, dpo);

      const bool full = k0 + BK <= t && qw_hi < t && (!causal || k0 + BK - 1 <= qw_lo) &&
                        (window <= 0 || qw_hi - k0 < window);
#pragma unroll
      for (int c = 0; c < kNK; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          float p = fast_exp2(fmaf(s[c][e], scale_log2, -l2[ri]));
          if (!full && !visible(i0 + r0 + 8 * ri, k0 + 8 * c + (kc ^ (e & 1)), t, causal, window))
            p = 0.0f;
          dpv[c][e] = p * (dpv[c][e] - de[ri]);
        }
      // dQ += dS K: B rows kc and kc ^ 1 of each k-step's 8 keys
      uint32_t ab[kNK][4], as[kNK][4];
      as_a<kNK, kSplit>(dpv, ab, as);
      accumulate<kNK, kNT, kSplit>(acc, ab, as, kst + kc * sq + g, (kc ^ 1) * sq - kc * sq, sq, 0,
                                   dpo);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = i0 + r0 + 8 * ri;
    if (row >= t) continue;
    T* out = dq + (((long long)bb * t + row) * h + head) * d;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t4 + e;
        if (col < d) out[col] = from_f32<T>(acc[n][2 * ri + e] * scale);
      }
  }
}

template <int DMAX>
constexpr size_t dkdv_smem_floats(int sqk) {
  using L = BwdTiles<DMAX>;
  return (size_t)2 * L::kBK * sqk + (size_t)4 * L::kBQ * sqk + (size_t)4 * L::kBQ +
         (L::kSplitD > 1 ? (size_t)L::kKvWarps * L::kBQ * 32 : 0);
}

template <int DMAX>
constexpr size_t dq_smem_floats(int sqk) {
  return (size_t)2 * kDqRows * sqk + (size_t)4 * BwdTiles<DMAX>::kBKq * sqk;
}

template <typename T, int DMAX, bool ASYNC>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                     const float* delta, float* dk_part, float* dv_part, T* dq, T* dk, T* dv,
                     int b, int t, int h, int hkv, int d, int causal, int window, int splits,
                     float scale_log2, float scale, cudaStream_t stream) {
  using L = BwdTiles<DMAX>;
  static_assert(dkdv_smem_floats<DMAX>(DMAX + 8) * 4 <= 232448 &&
                    dq_smem_floats<DMAX>(DMAX + 8) * 4 <= 232448,
                "shared memory");
  const int sqk = qk_stride((d + 7) & ~7);
  const size_t dkdv_bytes = sizeof(float) * dkdv_smem_floats<DMAX>(sqk);
  const size_t dq_bytes = sizeof(float) * dq_smem_floats<DMAX>(sqk);
  auto dkdv = flash_bwd_dkdv_tf32x3_kernel<T, DMAX, ASYNC>;
  auto dqk = flash_bwd_dq_tf32x3_kernel<T, DMAX, ASYNC>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  const unsigned key_tiles = (unsigned)((t + L::kBK - 1) / L::kBK);
  dkdv<<<dim3((unsigned)(hkv * splits), key_tiles, (unsigned)b), L::kKvWarps * 32, dkdv_bytes,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, dk_part, dv_part, b, t, h, hkv, d, causal,
                   window, splits, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = (long long)b * t * hkv * d;
    const long long blocks = (n + kRowThreads - 1) / kRowThreads;
    flash_bwd_sum_tf32x3_kernel<T><<<(unsigned)blocks, kRowThreads, 0, stream>>>(
        dk_part, dv_part, dk, dv, n, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dqk<<<dim3((unsigned)h, (unsigned)((t + kDqRows - 1) / kDqRows), (unsigned)b), kQWarps * 32,
        dq_bytes, stream>>>(q, k, v, dout, lse, delta, dq, t, h, hkv, d, causal, window,
                            scale_log2, scale);
  return cudaGetLastError();
}

// cp.async for float32 rows it can copy 16 bytes at a time, else plain loads
template <typename T, int DMAX>
cudaError_t launch_a(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                     const float* delta, float* dk_part, float* dv_part, T* dq, T* dk, T* dv,
                     int b, int t, int h, int hkv, int d, int causal, int window, int splits,
                     float scale_log2, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const bool aligned =
        d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
    if (aligned)
      return launch_d<T, DMAX, true>(q, k, v, dout, lse, delta, dk_part, dv_part, dq, dk, dv, b,
                                     t, h, hkv, d, causal, window, splits, scale_log2, scale,
                                     stream);
  }
  return launch_d<T, DMAX, false>(q, k, v, dout, lse, delta, dk_part, dv_part, dq, dk, dv, b, t,
                                  h, hkv, d, causal, window, splits, scale_log2, scale, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* scratch, void* dq, void* dk, void* dv, int b, int t,
                   int h, int hkv, int d, int causal, int window, int splits, double scale,
                   void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 || d > 256 ||
      splits < 1 || (h / hkv) % splits != 0 || b > 65535 || h > 65535 ||
      (t + BwdTiles<256>::kBK - 1) / BwdTiles<256>::kBK > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)b * t * h;
  const long long blocks = (rows * 32 + kRowThreads - 1) / kRowThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  float* delta = (float*)scratch;
  float* dk_part = delta + rows;
  float* dv_part = dk_part + (long long)splits * b * t * hkv * d;
  flash_bwd_delta_tf32x3_kernel<T><<<(unsigned)blocks, kRowThreads, 0, st>>>(
      (const T*)o, (const T*)dout, delta, rows, t, h, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  const T* dd = (const T*)dout;
  const float* ls = (const float*)lse;
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  const float sc = (float)scale;
  if (d <= 64)
    return launch_a<T, 64>(qq, kk, vv, dd, ls, delta, dk_part, dv_part, (T*)dq, (T*)dk, (T*)dv,
                           b, t, h, hkv, d, causal, window, splits, scale_log2, sc, st);
  if (d <= 128)
    return launch_a<T, 128>(qq, kk, vv, dd, ls, delta, dk_part, dv_part, (T*)dq, (T*)dk, (T*)dv,
                            b, t, h, hkv, d, causal, window, splits, scale_log2, sc, st);
  return launch_a<T, 256>(qq, kk, vv, dd, ls, delta, dk_part, dv_part, (T*)dq, (T*)dk, (T*)dv, b,
                          t, h, hkv, d, causal, window, splits, scale_log2, sc, st);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, o, dout, dq (B, T, H, d); k, v, dk, dv (B, T, Hkv, d); lse float32
// (B, H, T); all contiguous, of one dtype but lse. scratch: float32, B H T
// values (delta), then with splits > 1 the partials of dk and dv, 2 splits
// B T Hkv d values
cudaError_t repro_flash_attention_bwd_tf32x3_f32(const void* q, const void* k, const void* v,
                                                 const void* o, const void* dout,
                                                 const void* lse, void* scratch, void* dq,
                                                 void* dk, void* dv, int b, int t, int h,
                                                 int hkv, int d, int causal, int window,
                                                 int splits, double scale, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, h, hkv, d, causal,
                       window, splits, scale, stream);
}

cudaError_t repro_flash_attention_bwd_tf32x3_bf16(const void* q, const void* k, const void* v,
                                                  const void* o, const void* dout,
                                                  const void* lse, void* scratch, void* dq,
                                                  void* dk, void* dv, int b, int t, int h,
                                                  int hkv, int d, int causal, int window,
                                                  int splits, double scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, h, hkv, d,
                               causal, window, splits, scale, stream);
}

}  // extern "C"
