// Flash-attention backward for NVIDIA Hopper (sm_90a) on the tensor cores:
// the gradients dq, dk and dv of grouped-query self-attention, bfloat16
// q, k, v in (B, T, H, D) layout, head dim a multiple of 8 up to 256.
//
// Replaces no Pallas kernel: the reference has no backward kernel (nothing
// under src/repro/kernels defines a custom_vjp), and its training gradient
// is JAX's derivative of the jnp ops of repro.kernels.ref.mha_blocked,
// reached from src/repro/models/attention.py:104. It is the `sm90` route of
// the port's backward (the wrapper's flash_bwd_route); float32 and
// bfloat16 head dims that are not a multiple of 8 take the `tf32x3` route,
// csrc/flash_attention_bwd.cu, which computes the same contract on the
// tensor cores in 3xTF32. Its plain version is
// repro_torch.kernels.ref.mha_blocked_grad.
//
// What it computes, from the forward's output o and its row log-sum-exp
// lse (float32 (B, H, T)): with s = (q scale) . k and p = exp(s - lse) on
// the pairs the masks keep (causal kpos <= qpos, window kpos > qpos -
// window) and 0 elsewhere,
//   delta_i = sum_c dO_ic o_ic,   dS = p (dO . v - delta_i),
//   dv = sum_i p dO,   dk = sum_i dS (q scale),   dq = scale sum_j dS k,
// with dk and dv summed over the H / Hkv query heads of their KV head. Only
// self-attention: Tq = Tk and q_offset 0, where every row sees its own key.
//
// What bounds it: operations. The training shape (2, 2048, 32, 4, 64)
// causal does five products of 2 * 64 flops over 2 * 32 * 2,098,176
// visible pairs: 85.9 GFLOP, 0.0869 ms at the 989 TFLOP/s bf16 tensor-core
// peak; the seven products this design does take 0.122 ms there, against
// 25 MB of inputs and outputs (0.0075 ms at 3.35 TB/s).
//
// What the design does about it (FlashAttention-2's backward on the
// forward's wgmma forms, deterministic):
//   * Every product runs on the tensor cores as wgmma.mma_async m64n64k16
//     with float32 accumulators, in the two forms of the forward kernel
//     (csrc/flash_attention_sm90.cu, helpers in csrc/sm90.cuh): both
//     operands K-major in shared memory (wgmma_ss), or A from registers
//     and B MN-major in shared memory (wgmma_rs_mn). Tiles are 64 rows of
//     (B, T, heads, D) brought by TMA in 64-column boxes of 128-byte rows
//     with the 128-byte swizzle; one block is one warpgroup.
//   * flash_bwd_delta_sm90_kernel: delta, and lse log2(e), into float32
//     (B, H, Tpad) scratch, Tpad = T rounded up to 64 and zero past T, so a
//     tile's 64 values are one 16-byte-aligned 1-D bulk copy.
//   * flash_bwd_dkdv_sm90_kernel: a block owns a 64-key tile of one KV head
//     (K and V by TMA once) and walks the query tiles that see its keys,
//     for the query heads it owns; Q, dO and the tile's lse2 and delta
//     rows come through a ring of two stages, an mbarrier each. A query
//     tile is four products: S^T = K Q^T and dP^T = V dO^T (wgmma_ss);
//     P^T = exp2(S^T scale log2(e) - lse2) masked in registers and dS^T =
//     P^T (dP^T - delta), both rounded to bfloat16 in registers (the
//     accumulator layout is the A-fragment layout, as for the forward's
//     P); dV += P^T dO and dK += dS^T Q (wgmma_rs_mn, dO and Q as MN-major
//     B operands, as the forward's P V reads V). dK takes scale in the
//     epilogue: q scale is never rounded to bfloat16. At D = 256 a block
//     is two warpgroups: each computes S^T and dP^T whole (two products
//     done twice) and owns half of dK's and dV's columns, since one
//     warpgroup's float32 dK and dV of 64 x 256 would take 256 registers
//     a thread.
//   * flash_bwd_dq_sm90_kernel: a block owns a 64-row query tile of one
//     head (Q, dO by TMA once) and walks the key tiles its rows see, K and
//     V through two stages: S = Q K^T, dP = dO V^T, dS in bfloat16
//     registers, dQ += dS K (K MN-major; 64 x D float32 accumulators, 128
//     registers a thread at D = 256); dq scale in the epilogue. The
//     last query tiles, the heaviest under the causal mask, start first.
//     S and dP are recomputed here: seven products for five, no atomics.
//   * Tiles that hold a masked pair (the diagonal, the window's edge, the
//     ragged end of T) test each pair; every other tile skips the test.
//   * GQA: a dk/dv block sums its query heads in a fixed order in
//     registers. Two layouts of that sum were timed in one call on an
//     H100 (80GB HBM3, 700 W) at the training shape (tools/flash_bwd.py
//     --part layouts): (a)
//     the whole group of 8 heads in one block, 256 blocks, 0.4266 ms (the
//     causal j = 0 block walks 256 query tiles while the mean walks 132,
//     and one SM holds three blocks, so the long blocks run on alone);
//     (b) a block a head, 2048 blocks, 0.2979 ms, its float32 partials
//     (splits, B, T, Hkv, D) added by flash_bwd_sum_sm90_kernel in split
//     order and rounded to bfloat16 (that pass alone 0.027 ms). Between them,
//     4 runs of 2 heads (1024 blocks) took 0.2804 ms: fewer blocks leave
//     the tail alone, more add partial traffic. The wrapper's
//     bwd_sm90_splits keeps that middle: the fewest runs that give the
//     grid about four blocks a SM at D = 64 and two at D = 128 and 256
//     (qwen1.5's heads: 2 runs 0.4823 ms against 1 run 0.6190 and 8 runs
//     0.5555).
//   * No floating-point atomics: a second call repeats bit for bit.
//
// Rounding P and dS to bfloat16 as wgmma A operands is the one departure
// from the contract's arithmetic; every sum accumulates in float32.
//
// Every entry point launches on the given stream, allocates nothing (the
// caller's float32 scratch holds lse2, delta and the partials) and returns
// cudaGetLastError() after the launches, or the first error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;         // query rows and keys of a tile: one wgmma M or N
constexpr int kThreads = 128;     // one warpgroup
constexpr int kStages = 2;
constexpr int kRowThreads = 256;  // the delta pass and the split sum
constexpr float kLog2e = 1.4426950408889634f;

template <int DT>
struct BwdSm90Tiles {
  static constexpr int kBoxes = DT / kBox;          // column boxes of a tile
  // dk/dv: warpgroups a block, each owning kOwn column boxes of dK and dV
  // (at D = 256 one warpgroup's 64 x 256 float32 dK and dV would take 256
  // registers a thread)
  static constexpr int kWarpgroups = DT > 128 ? 2 : 1;
  static constexpr int kOwn = kBoxes / kWarpgroups;
  static constexpr int kTileBytes = kTile * DT * 2;  // 64 rows of bfloat16
  static constexpr int kStatBytes = 2 * kTile * 4;   // a query tile's lse2 and delta
  // dk/dv: K and V once; Q, dO and the statistics in each stage; barriers
  // kv and stage[2]
  static constexpr int kDkdvK = 0;
  static constexpr int kDkdvV = kDkdvK + kTileBytes;
  static constexpr int kDkdvQ = kDkdvV + kTileBytes;  // stage s at + s * kTileBytes
  static constexpr int kDkdvDO = kDkdvQ + kStages * kTileBytes;
  static constexpr int kDkdvStat = kDkdvDO + kStages * kTileBytes;  // + s * kStatBytes
  static constexpr int kDkdvBar = kDkdvStat + kStages * kStatBytes;
  static constexpr int kDkdvBytes = kDkdvBar + 64 + 1024;  // + slack to align to 1024
  // dq: Q and dO once; K and V in each stage; barriers q and stage[2]
  static constexpr int kDqQ = 0;
  static constexpr int kDqDO = kDqQ + kTileBytes;
  static constexpr int kDqK = kDqDO + kTileBytes;  // stage s at + s * kTileBytes
  static constexpr int kDqV = kDqK + kStages * kTileBytes;
  static constexpr int kDqBar = kDqV + kStages * kTileBytes;
  static constexpr int kDqBytes = kDqBar + 64 + 1024;
  static_assert(kTileBytes % 1024 == 0, "swizzle atoms");
};

__device__ __forceinline__ bool visible(int qi, int kj, int t, int causal, int window) {
  return qi < t && kj < t && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// every pair of query tile [i0, i0 + 64) and key tile [j0, j0 + 64) is kept
__device__ __forceinline__ bool all_visible(int i0, int j0, int t, int causal, int window) {
  return i0 + kTile <= t && j0 + kTile <= t && (!causal || j0 + kTile - 1 <= i0) &&
         (window <= 0 || j0 > i0 + kTile - 1 - window);
}

// lse2 = lse log2(e) and delta = sum_c dO o of row (b, head, i), both at
// (b h + head) Tpad + i and zero for i in [t, tpad): eight lanes a row, 16
// bytes of o and of dO a lane a step; rows run (b, head, i), i fastest, so
// a block's stores are contiguous and each row's loads are
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_delta_sm90_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ lse2,
                            float* __restrict__ delta, int b, int t, int tpad, int h, int d) {
  const long long rows = (long long)b * h * tpad;
  const long long row = ((long long)blockIdx.x * kRowThreads + threadIdx.x) / 8;
  const int sub = threadIdx.x % 8;
  const int i = (int)(row % tpad);
  const long long bh = row / tpad;  // bb h + head
  const bool live = row < rows && i < t;
  float s = 0.0f;
  if (live) {
    const long long at = (((bh / h) * t + i) * h + bh % h) * d;
    const uint4* po = reinterpret_cast<const uint4*>(o + at);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
    for (int c = sub; c < d / 8; c += 8) {
      const uint4 a = po[c], g = pd[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fa = __bfloat1622float2(a2[e]), fg = __bfloat1622float2(g2[e]);
        s = fmaf(fg.x, fa.x, s);
        s = fmaf(fg.y, fa.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (sub == 0 && row < rows) {
    delta[row] = live ? s : 0.0f;
    lse2[row] = live ? lse[bh * t + i] * kLog2e : 0.0f;
  }
}

// Accumulator fragment of an m64n64 wgmma: thread (warp w, lane l) holds
// element i of a 64 x 64 tile at row 16 w + l / 4 + 8 ((i >> 1) & 1) and
// column 8 (i >> 2) + 2 (l % 4) + (i & 1); elements i and i + 1, rounded
// to bfloat16 and packed, are register (i % 8) / 2 of the A fragment of
// k-step i / 8 of a product that sums over the tile's columns.

// dk and dv of key tile blockIdx.y of KV head blockIdx.x / splits, batch
// row blockIdx.z, over query heads run blockIdx.x % splits of its group;
// with two warpgroups each computes S^T and dP^T whole and owns half of
// dK's and dV's columns
template <int DT>
__global__ void __launch_bounds__(kThreads * BwdSm90Tiles<DT>::kWarpgroups, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse2, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           float* __restrict__ dk_part, float* __restrict__ dv_part, int b,
                           int t, int tpad, int h, int hkv, int d, int causal, int window,
                           int splits, float scale_log2, float scale) {
  using L = BwdSm90Tiles<DT>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors agree on 1024-byte atoms
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_kv = base + L::kDkdvBar;
  const uint32_t bar_st = bar_kv + 8;  // + 8 s
  const float* stat = reinterpret_cast<const float*>(smem + L::kDkdvStat);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;  // this warpgroup's boxes: wg kOwn + c
  const int warp = (tid % kThreads) / 32, lane = tid % 32;
  const int kvh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int j0 = blockIdx.y * kTile;  // key tile 0 sees the most query tiles: it starts first
  const int bb = blockIdx.z;
  const int group = h / hkv, per = group / splits;
  const int head0 = kvh * group + split * per;

  // the query tiles that see a key of this tile, for each of `per` heads
  const int j_hi = min(j0 + kTile, t) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 && window <= t ? min(t - 1, j_hi + window - 1) : t - 1;
  const int qt_first = i_lo / kTile;
  const int n_q = i_hi / kTile - qt_first + 1;
  const int n_iter = per * n_q;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q, dO, lse2 and delta of step n (head n / n_q, query tile n % n_q)
  // into stage s
  auto load_stage = [&](int s, int n) {
    const int head = head0 + n / n_q;
    const int i0 = (qt_first + n % n_q) * kTile;
    const uint32_t bar = bar_st + 8 * s;
    const uint32_t qs = base + L::kDkdvQ + s * L::kTileBytes;
    const uint32_t dos = base + L::kDkdvDO + s * L::kTileBytes;
    const uint32_t st = base + L::kDkdvStat + s * L::kStatBytes;
    const long long row = ((long long)bb * h + head) * tpad + i0;
    mbar_expect_tx(bar, 2 * L::kTileBytes + L::kStatBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(qs + c * kTile * kRowBytes, &qmap, bar, c * kBox, head, i0, bb);
      tma_load(dos + c * kTile * kRowBytes, &domap, bar, c * kBox, head, i0, bb);
    }
    bulk_load(st, lse2 + row, kTile * 4, bar);
    bulk_load(st + kTile * 4, delta + row, kTile * 4, bar);
  };

  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(base + L::kDkdvK + c * kTile * kRowBytes, &kmap, bar_kv, c * kBox, kvh, j0, bb);
      tma_load(base + L::kDkdvV + c * kTile * kRowBytes, &vmap, bar_kv, c * kBox, kvh, j0, bb);
    }
    for (int s = 0; s < kStages && s < n_iter; ++s) load_stage(s, s);
  }
  __syncwarp();

  const int c0 = 2 * (lane % 4);
  const int kr = j0 + warp * 16 + lane / 4;  // this thread's keys: kr and kr + 8
  float dk_acc[L::kOwn][32], dv_acc[L::kOwn][32];
#pragma unroll
  for (int c = 0; c < L::kOwn; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int n = 0; n < n_iter; ++n) {
    const int s = n % kStages;
    const int i0 = (qt_first + n % n_q) * kTile;
    const uint32_t qs = base + L::kDkdvQ + s * L::kTileBytes;
    const uint32_t dos = base + L::kDkdvDO + s * L::kTileBytes;
    mbar_wait(bar_st + 8 * s, (n / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: k-steps of 16 along D, 32 bytes apart
    // inside a 128-byte row and a whole box apart across boxes
    float st[32], dpt[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      wgmma_ss(st, sw128_desc(base + L::kDkdvK + off, 16, 1024), sw128_desc(qs + off, 16, 1024),
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      wgmma_ss(dpt, sw128_desc(base + L::kDkdvV + off, 16, 1024),
               sw128_desc(dos + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(st);
    pin(dpt);

    // P^T and dS^T, keys in rows and queries in columns, as the bfloat16
    // A fragments of the next two products
    const float* ls = stat + s * (L::kStatBytes / 4);
    const float* dl = ls + kTile;
    const bool full = all_visible(i0, j0, t, causal, window);
    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + c0;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 de = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int i = 4 * jj + 2 * ri;
        float p0 = fast_exp2(fmaf(st[i], scale_log2, -l2.x));
        float p1 = fast_exp2(fmaf(st[i + 1], scale_log2, -l2.y));
        if (!full) {
          const int key = kr + 8 * ri;
          if (!visible(i0 + col, key, t, causal, window)) p0 = 0.0f;
          if (!visible(i0 + col + 1, key, t, causal, window)) p1 = 0.0f;
        }
        pa[jj / 2][2 * (jj % 2) + ri] = pack_bf16(p0, p1);
        da[jj / 2][2 * (jj % 2) + ri] =
            pack_bf16(p0 * (dpt[i] - de.x), p1 * (dpt[i + 1] - de.y));
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warpgroup's boxes: dO's and
    // Q's rows are the queries (K) and their columns D (N) run along the
    // 128-byte rows, one box per 64 columns; 8 rows are 1024 bytes
#pragma unroll
    for (int c = 0; c < L::kOwn; ++c) {
      pin(dv_acc[c]);
      pin(dk_acc[c]);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pin(pa[kk]);
      pin(da[kk]);
    }
    const uint32_t own = (wg * L::kOwn) * kTile * kRowBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kOwn; ++c)
        wgmma_rs_mn(dv_acc[c], pa[kk],
                    sw128_desc(dos + own + c * kTile * kRowBytes + kk * 16 * kRowBytes, 1024,
                               1024));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kOwn; ++c)
        wgmma_rs_mn(dk_acc[c], da[kk],
                    sw128_desc(qs + own + c * kTile * kRowBytes + kk * 16 * kRowBytes, 1024,
                               1024));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < L::kOwn; ++c) {
      pin(dv_acc[c]);
      pin(dk_acc[c]);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pin(pa[kk]);
      pin(da[kk]);
    }

    // every warp's wgmmas have read stage s: refill it with step n + 2
    __syncthreads();
    if (tid == 0 && n + kStages < n_iter) load_stage(s, n + kStages);
    __syncwarp();
  }

  // dk takes the scale of (q scale); one split writes bfloat16, several
  // write float32 partials (splits, B, T, Hkv, D)
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int key = kr + 8 * ri;
    if (key >= t) continue;
    const long long at = (((long long)bb * t + key) * hkv + kvh) * d;
    const long long part = ((long long)split * b * t * hkv) * d + at;
#pragma unroll
    for (int c = 0; c < L::kOwn; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = (wg * L::kOwn + c) * kBox + 8 * jj + c0;
        if (col >= d) continue;
        const int i = 4 * jj + 2 * ri;
        const float2 gk = make_float2(dk_acc[c][i] * scale, dk_acc[c][i + 1] * scale);
        const float2 gv = make_float2(dv_acc[c][i], dv_acc[c][i + 1]);
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + col) = __float22bfloat162_rn(gk);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + col) = __float22bfloat162_rn(gv);
        } else {
          *reinterpret_cast<float2*>(dk_part + part + col) = gk;
          *reinterpret_cast<float2*>(dv_part + part + col) = gv;
        }
      }
  }
}

// dk and dv from the partials of `splits` runs of heads, added in run order
// and rounded to bfloat16: four values a thread
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_sum_sm90_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          long long n, int splits) {
  const long long i4 = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i4 * 4 >= n) return;
  float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 xk = reinterpret_cast<const float4*>(dk_part + s * n)[i4];
    const float4 xv = reinterpret_cast<const float4*>(dv_part + s * n)[i4];
    sk.x += xk.x, sk.y += xk.y, sk.z += xk.z, sk.w += xk.w;
    sv.x += xv.x, sv.y += xv.y, sv.z += xv.z, sv.w += xv.w;
  }
  __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i4;
  __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i4;
  pk[0] = __floats2bfloat162_rn(sk.x, sk.y);
  pk[1] = __floats2bfloat162_rn(sk.z, sk.w);
  pv[0] = __floats2bfloat162_rn(sv.x, sv.y);
  pv[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// dq of query tile (gridDim.y - 1 - blockIdx.y) of head blockIdx.x, batch
// row blockIdx.z, over the key tiles its rows see
template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int t, int tpad, int h, int hkv, int d,
                         int causal, int window, float scale_log2, float scale) {
  using L = BwdSm90Tiles<DT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_q = base + L::kDqBar;
  const uint32_t bar_kv = bar_q + 8;  // + 8 s

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int bb = blockIdx.z;
  const int kvh = head / (h / hkv);

  // the key tiles the tile's rows see
  const int i_hi = min(i0 + kTile, t) - 1;
  const int j_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int j_hi = causal ? i_hi : t - 1;
  const int kt_first = j_lo / kTile;
  const int n_k = j_hi / kTile - kt_first + 1;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of key tile `tile` into stage s
  auto load_kv = [&](int s, int tile) {
    const uint32_t bar = bar_kv + 8 * s;
    const uint32_t ks = base + L::kDqK + s * L::kTileBytes;
    const uint32_t vs = base + L::kDqV + s * L::kTileBytes;
    mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(ks + c * kTile * kRowBytes, &kmap, bar, c * kBox, kvh, tile * kTile, bb);
      tma_load(vs + c * kTile * kRowBytes, &vmap, bar, c * kBox, kvh, tile * kTile, bb);
    }
  };

  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(base + L::kDqQ + c * kTile * kRowBytes, &qmap, bar_q, c * kBox, head, i0, bb);
      tma_load(base + L::kDqDO + c * kTile * kRowBytes, &domap, bar_q, c * kBox, head, i0, bb);
    }
    for (int s = 0; s < kStages && s < n_k; ++s) load_kv(s, kt_first + s);
  }
  __syncwarp();

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);
  float l2[2], de[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const long long at = ((long long)bb * h + head) * tpad + i0 + r0 + 8 * ri;
    l2[ri] = lse2[at];
    de[ri] = delta[at];
  }
  float acc[L::kBoxes][32];
#pragma unroll
  for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kStages;
    const int k0 = (kt_first + j) * kTile;
    const uint32_t ks = base + L::kDqK + s * L::kTileBytes;
    const uint32_t vs = base + L::kDqV + s * L::kTileBytes;
    mbar_wait(bar_kv + 8 * s, (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(base + L::kDqQ + off, 16, 1024), sw128_desc(ks + off, 16, 1024),
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;
      wgmma_ss(dp, sw128_desc(base + L::kDqDO + off, 16, 1024), sw128_desc(vs + off, 16, 1024),
               kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    // dS, queries in rows and keys in columns, as the bfloat16 A fragments
    // of dS K
    const bool full = all_visible(i0, k0, t, causal, window);
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ri = (i >> 1) & 1;
      float p0 = fast_exp2(fmaf(sc[i], scale_log2, -l2[ri]));
      float p1 = fast_exp2(fmaf(sc[i + 1], scale_log2, -l2[ri]));
      if (!full) {
        const int qi = i0 + r0 + 8 * ri;
        const int key = k0 + 8 * (i >> 2) + c0;
        if (!visible(qi, key, t, causal, window)) p0 = 0.0f;
        if (!visible(qi, key + 1, t, causal, window)) p1 = 0.0f;
      }
      da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dp[i] - de[ri]), p1 * (dp[i + 1] - de[ri]));
    }

    // dQ += dS K: K's rows are the keys (K), its columns D (N)
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb) pin(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) pin(da[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < L::kBoxes; ++cb)
        wgmma_rs_mn(acc[cb], da[kk],
                    sw128_desc(ks + cb * kTile * kRowBytes + kk * 16 * kRowBytes, 1024, 1024));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb) pin(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) pin(da[kk]);

    // every warp's wgmmas have read stage s: refill it with tile j + 2
    __syncthreads();
    if (tid == 0 && j + kStages < n_k) load_kv(s, kt_first + j + kStages);
    __syncwarp();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = i0 + r0 + 8 * ri;
    if (row >= t) continue;
    __nv_bfloat16* out = dq + (((long long)bb * t + row) * h + head) * d;
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = cb * kBox + 8 * jj + c0;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
              acc[cb][4 * jj + 2 * ri] * scale, acc[cb][4 * jj + 2 * ri + 1] * scale);
      }
  }
}

template <int DT>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse2, const float* delta, float* dk_part, float* dv_part,
                     void* dq, void* dk, void* dv, int b, int t, int tpad, int h, int hkv, int d,
                     int causal, int window, int splits, float scale_log2, float scale,
                     cudaStream_t stream) {
  using L = BwdSm90Tiles<DT>;
  static_assert(L::kDkdvBytes <= 232448 && L::kDqBytes <= 232448, "shared memory");
  auto dkdv = flash_bwd_dkdv_sm90_kernel<DT>;
  auto dqk = flash_bwd_dq_sm90_kernel<DT>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkdvBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode(fn, &qmap, q, b, t, h, d, kTile) || !encode(fn, &kmap, k, b, t, hkv, d, kTile) ||
      !encode(fn, &vmap, v, b, t, hkv, d, kTile) || !encode(fn, &domap, dout, b, t, h, d, kTile))
    return cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)(tpad / kTile);
  dkdv<<<dim3((unsigned)(hkv * splits), tiles, (unsigned)b), kThreads * L::kWarpgroups,
         L::kDkdvBytes, stream>>>(
      qmap, kmap, vmap, domap, lse2, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, dk_part,
      dv_part, b, t, tpad, h, hkv, d, causal, window, splits, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = (long long)b * t * hkv * d;
    const long long blocks = (n / 4 + kRowThreads - 1) / kRowThreads;
    flash_bwd_sum_sm90_kernel<<<(unsigned)blocks, kRowThreads, 0, stream>>>(
        dk_part, dv_part, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dqk<<<dim3((unsigned)h, tiles, (unsigned)b), kThreads, L::kDqBytes, stream>>>(
      qmap, kmap, vmap, domap, lse2, delta, (__nv_bfloat16*)dq, t, tpad, h, hkv, d, causal,
      window, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, o, dout, dq (B, T, H, d); k, v, dk, dv (B, T, Hkv, d); lse float32
// (B, H, T); all contiguous bfloat16 but lse, 16-byte aligned. scratch:
// float32, 2 B H Tpad values (lse2, delta; Tpad = T rounded up to 64), then
// with splits > 1 the partials of dk and dv, 2 splits B T Hkv d values
cudaError_t repro_flash_attention_bwd_sm90_bf16(const void* q, const void* k, const void* v,
                                                const void* o, const void* dout,
                                                const void* lse, void* scratch, void* dq,
                                                void* dk, void* dv, int b, int t, int h,
                                                int hkv, int d, int causal, int window,
                                                int splits, double scale, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 || d % 8 != 0 ||
      d > 256 || splits < 1 || (h / hkv) % splits != 0 || b > 65535 || h > 65535 ||
      (t + kTile - 1) / kTile > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(scratch) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tpad = (t + kTile - 1) / kTile * kTile;
  float* lse2 = (float*)scratch;
  float* delta = lse2 + (long long)b * h * tpad;
  float* dk_part = delta + (long long)b * h * tpad;
  float* dv_part = dk_part + (long long)splits * b * t * hkv * d;
  const long long blocks = ((long long)b * tpad * h * 8 + kRowThreads - 1) / kRowThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta_sm90_kernel<<<(unsigned)blocks, kRowThreads, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse, lse2, delta, b, t,
      tpad, h, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  if (d <= 64)
    return launch_d<64>(q, k, v, dout, lse2, delta, dk_part, dv_part, dq, dk, dv, b, t, tpad, h,
                        hkv, d, causal, window, splits, scale_log2, (float)scale, st);
  if (d <= 128)
    return launch_d<128>(q, k, v, dout, lse2, delta, dk_part, dv_part, dq, dk, dv, b, t, tpad, h,
                         hkv, d, causal, window, splits, scale_log2, (float)scale, st);
  return launch_d<256>(q, k, v, dout, lse2, delta, dk_part, dv_part, dq, dk, dv, b, t, tpad, h,
                       hkv, d, causal, window, splits, scale_log2, (float)scale, st);
}

}  // extern "C"
