// Grouped-query flash attention for NVIDIA Hopper (sm_90a) on the tensor
// cores: bfloat16 q, k, v in (B, T, H, D) layout, head dim a multiple of 8
// up to 256.
//
// Replaces the Pallas TPU kernel
//   flash_attention_pallas  (src/repro/kernels/flash_attention.py:72, body _fa_kernel)
// for bfloat16 inputs, and computes its contract, repro.kernels.ref.mha_blocked
// (the plain version here is repro_torch.kernels.ref.mha_blocked): masks are
// causal (kpos <= q_offset + row), a sliding window (kpos > qpos - window,
// window <= 0 meaning none) and the padding mask kpos < tk, each masked logit
// set to -2^30; the softmax is online in float32 with the running max
// starting at -inf; the output is acc / max(l, 1e-30), rounded to bfloat16.
// The KV head of q head h is h / (H / Hkv), read in place: no KV expansion.
// Float32 inputs, and bfloat16 head dims that are not a multiple of 8, take
// the 3xTF32 tensor-core kernel of csrc/flash_attention.cu (the wrapper's
// flash_route).
//
// What bounds it: operations. A causal TinyLlama prefill layer, (1, 2048,
// 32 heads, 4 KV heads, 64), does 4 * 64 * 32 * 2048 * 2049 / 2 = 17.2 GFLOP
// on 18.9 MB of q, k, v and o: 0.0174 ms at the 989 TFLOP/s bf16 tensor-core
// peak against 0.0056 ms for the bytes at 3.35 TB/s.
//
// What the design does about it: both products run on the tensor cores as
// wgmma.mma_async m64n64k16 with float32 accumulators.
//   * One block is one warpgroup (128 threads) and one 64-row q tile of one
//     (q head, batch row). TMA brings the q tile once, and K and V tiles of
//     64 keys through a ring of two stages in shared memory, each stage with
//     its own mbarrier for K and for V: the copy of key tile j + 1 runs while
//     tile j is computed. Tiles are 64-column boxes of 128-byte rows with the
//     128-byte swizzle, which is the layout the wgmma descriptors name.
//   * S = Q K^T with Q and K both K-major in shared memory (rows of (B, T, H,
//     D) run along D). The softmax scale, times log2(e), is applied to the
//     float32 accumulator (q * scale is never rounded to bfloat16); the masks
//     are applied to the accumulator fragment in registers, and only in tiles
//     that hold a masked pair.
//   * O += P V with P rounded to bfloat16 in registers as the A operand (the
//     accumulator layout of S is the A-fragment layout) and V as an MN-major
//     (transposed) B operand from shared memory. Rounding P is the one
//     departure from the contract's arithmetic; the row sums l use P in
//     float32.
//   * Key tiles wholly above the causal diagonal or outside the window of all
//     rows of the block are skipped: exact for every row that sees a key (a
//     masked tile adds exp(-2^30 - m) = 0, and tiles before the row's first
//     visible key are wiped by alpha = 0, as in the contract). A row that sees
//     no key gets the contract's closed form, the sum of v over all tk keys
//     divided by nk * block_k (empty_denom), from a second pass that runs only
//     in blocks that hold such a row. The grid puts the heads innermost and
//     runs q tiles from the last: the heaviest causal tiles start first.
//   * The kernel is templated on the head dim's width DT in {64, 128, 256};
//     a head dim below it (8, 112) is zero-filled by TMA up to it. The key
//     tile is 64 at every width: at D = 64 a tile of 128 keys measured
//     slower on the card (more registers, fewer blocks a SM, more masked
//     pairs on the diagonal), and at D = 256 the 64 x 256 float32 O
//     accumulator already takes 128 registers a thread.
//
// With a non-null `lse` the kernel also writes each row's natural
// log-sum-exp of its scaled logits, ln 2 (m + log2 l) from the epilogue's
// row statistics, as float32 (B, H, Tq): the training forward saves it for
// the backward (csrc/flash_attention_bwd.cu). The serving path passes null
// and its output is unchanged: the store sits beside the output's, which
// it does not touch.
//
// The tensor maps are encoded on the host for every call with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda. Every entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() after the launch (or the
// error that stopped it before).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // q rows per block: one warpgroup, one wgmma M
constexpr int kBN = 64;          // keys per tile: one wgmma N of S, one box of rows
constexpr int kThreads = 128;    // one warpgroup
constexpr int kBox = 64;         // bf16 columns of one TMA box: a 128-byte row
constexpr int kRowBytes = 128;
constexpr int kStages = 2;
// -2^30, the contract's mask value, in the log2 units the softmax runs in
constexpr float kMask = -1073741824.0f * 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DT>
struct Layout {
  static constexpr int kBoxes = DT / kBox;           // column boxes of a tile
  static constexpr int kQBytes = kBM * DT * 2;
  static constexpr int kKVBytes = kBN * DT * 2;      // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;            // stage s at kK + s * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q, k[2], v[2]: 8 B each
  static constexpr int kSum = kBar + 64;             // DT floats (rows with no key)
  static constexpr int kBytes = kSum + DT * 4 + 1024;  // + slack to align to 1024
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "swizzle atoms");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// both K-major; d is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64) with B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of an m64n64 wgmma: thread (warp w, lane l) holds
// element i of a 64 x 64 tile at row 16 w + l / 4 + 8 ((i >> 1) & 1) and
// column 8 (i >> 2) + 2 (l % 4) + (i & 1).
template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int tq, int tk, int h, int hkv, int d,
                            int causal, int window, int q_offset, float scale_log2,
                            float empty_denom) {
  using L = Layout<DT>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors agree on 1024-byte atoms
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;   // + 8 s
  const uint32_t bar_v = bar_q + 24;  // + 8 s
  float* colsum = reinterpret_cast<float*>(smem + L::kSum);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int bb = blockIdx.z;
  const int kvh = head / (h / hkv);

  // the key tiles any row of this block can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + kBM, tq) - 1;
  const int b_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int b_hi = causal ? min(tk - 1, q_hi) : tk - 1;
  const int t_first = b_lo / kBN;
  const int n_tiles = b_hi >= b_lo ? b_hi / kBN - t_first + 1 : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of key tile `tile` into stage s
  auto load_kv = [&](int s, int tile) {
    const uint32_t ks = base + L::kK + s * L::kKVBytes;
    const uint32_t vs = base + L::kV + s * L::kKVBytes;
    mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load(ks + c * kBN * kRowBytes, &kmap, bar_k + 8 * s, c * kBox, kvh, tile * kBN, bb);
    mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load(vs + c * kBN * kRowBytes, &vmap, bar_v + 8 * s, c * kBox, kvh, tile * kBN, bb);
  };

  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load(base + L::kQ + c * kBM * kRowBytes, &qmap, bar_q, c * kBox, head, i0, bb);
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, t_first + s);
  }
  __syncwarp();

  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);
  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    qpos[ri] = q_offset + i0 + r0 + 8 * ri;
    m[ri] = -INFINITY;
    l[ri] = 0.0f;  // this thread's share of the row sum
  }
  float acc[L::kBoxes][32];
#pragma unroll
  for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = (t_first + j) * kBN;
    const uint32_t ks = base + L::kK + s * L::kKVBytes;
    const uint32_t vs = base + L::kV + s * L::kKVBytes;
    if (j == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_k + 8 * s, parity);

    // S = Q K^T: k-steps of 16 along D, 32 bytes apart inside a 128-byte row
    // and a whole box apart across boxes; 8-row groups 1024 bytes apart
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kBN * kRowBytes + (kk % 4) * 32;
      const uint64_t da =
          sw128_desc(base + L::kQ + (kk / 4) * kBM * kRowBytes + (kk % 4) * 32, 16, 1024);
      wgmma_ss(sc, da, sw128_desc(ks + koff, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);

    // scale, mask, online softmax in log2 units
    const bool full = k0 + kBN <= tk && (!causal || k0 + kBN - 1 <= q_lo) &&
                      (window <= 0 || k0 > q_hi - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      float t = sc[i] * scale_log2;
      if (!full) {
        const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const bool ok = key < tk && (!causal || key <= qpos[ri]) &&
                        (window <= 0 || key > qpos[ri] - window);
        if (!ok) t = kMask;
      }
      sc[i] = t;
      mx[ri] = fmaxf(mx[ri], t);
    }
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      alpha[ri] = fast_exp2(m[ri] - m_new);
      m[ri] = m_new;
      l[ri] *= alpha[ri];
    }
    // P in float32 for the row sums, rounded to bfloat16 as the A fragments
    // of P V: k-step kk covers keys 16 kk .. 16 kk + 15 of the tile
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ri = (i >> 1) & 1;
      const float p0 = fast_exp2(sc[i] - m[ri]);
      const float p1 = fast_exp2(sc[i + 1] - m[ri]);
      l[ri] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];

    // O += P V: V's rows are the keys (K) and its columns D (N) run along
    // the 128-byte rows, one box per 64 columns; 8 keys are 1024 bytes. An
    // n64 wgmma spans one box, so the leading offset (the stride between
    // 64-column atoms) is never stepped over
    mbar_wait(bar_v + 8 * s, parity);
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb) pin(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) pin(pa[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < L::kBoxes; ++cb)
        wgmma_rs_mn(acc[cb], pa[kk],
                    sw128_desc(vs + cb * kBN * kRowBytes + kk * 16 * kRowBytes, 1024, 1024));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb) pin(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) pin(pa[kk]);

    // every warp's wgmmas have read stage s: refill it with tile j + 2
    __syncthreads();
    if (tid == 0 && j + kStages < n_tiles) load_kv(s, t_first + j + kStages);
    __syncwarp();
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }

  // rows with no visible key: the sum of v over all keys / empty_denom
  bool empty[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = i0 + r0 + 8 * ri;
    const int lo = window > 0 ? max(0, qpos[ri] - window + 1) : 0;
    const int hi = causal ? min(tk - 1, qpos[ri]) : tk - 1;
    empty[ri] = t < tq && lo > hi;
  }
  if (__syncthreads_or(empty[0] || empty[1])) {
    for (int c = tid; c < d; c += kThreads) {
      float sum = 0.0f;
      const __nv_bfloat16* col = v + ((long long)bb * tk * hkv + kvh) * d + c;
      for (int key = 0; key < tk; ++key) sum += __bfloat162float(col[(long long)key * hkv * d]);
      colsum[c] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (!empty[ri]) continue;
      l[ri] = empty_denom;
#pragma unroll
      for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = cb * kBox + 8 * (i >> 2) + c0 + (i & 1);
          if (((i >> 1) & 1) == ri) acc[cb][i] = col < d ? colsum[col] : 0.0f;
        }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = i0 + r0 + 8 * ri;
    if (t >= tq) continue;
    // the row's natural log-sum-exp of the scaled logits, for the backward
    // (csrc/flash_attention_bwd.cu); m and l are in log2 units, shared by
    // the quad
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)bb * h + head) * tq + t] = (m[ri] + log2f(l[ri])) * kLn2;
    const float den = fmaxf(l[ri], 1e-30f);
    __nv_bfloat16* row = o + (((long long)bb * tq + t) * h + head) * d;
#pragma unroll
    for (int cb = 0; cb < L::kBoxes; ++cb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = cb * kBox + 8 * jj + c0;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
              acc[cb][4 * jj + 2 * ri] / den, acc[cb][4 * jj + 2 * ri + 1] / den);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, T, heads, d) bfloat16 as a 4-D map, innermost first, with boxes of
// 64 columns x `rows` positions of one head and one batch row; columns past
// d and positions past t read as zero
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b, int t, int heads, int d,
            int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)t * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DT>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                     int tq, int tk, int h, int hkv, int d, int causal, int window, int q_offset,
                     float scale_log2, float empty_denom, void* stream) {
  const int smem = Layout<DT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_sm90_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(fn, &qmap, q, b, tq, h, d, kBM) || !encode(fn, &kmap, k, b, tk, hkv, d, kBN) ||
      !encode(fn, &vmap, v, b, tk, hkv, d, kBN))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)h, (unsigned)((tq + kBM - 1) / kBM), (unsigned)b);
  flash_attention_sm90_kernel<DT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, tq, tk, h, hkv, d, causal,
      window, q_offset, scale_log2, empty_denom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

cudaError_t repro_flash_attention_sm90_bf16(const void* q, const void* k, const void* v,
                                            void* o, float* lse, int b, int tq, int tk, int h,
                                            int hkv, int d, int causal, int window, int q_offset,
                                            double scale, double empty_denom, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || d <= 0 ||
      d % 8 != 0 || d > 256 || b > 65535 || (tq + kBM - 1) / kBM > 65535 || q_offset < 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return cudaErrorInvalidValue;
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  if (d <= 64)
    return launch_d<64>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset,
                        scale_log2, (float)empty_denom, stream);
  if (d <= 128)
    return launch_d<128>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset,
                         scale_log2, (float)empty_denom, stream);
  return launch_d<256>(q, k, v, o, lse, b, tq, tk, h, hkv, d, causal, window, q_offset,
                       scale_log2, (float)empty_denom, stream);
}

}  // extern "C"
