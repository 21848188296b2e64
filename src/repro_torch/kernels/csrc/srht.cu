// Walsh-Hadamard transform and the fused SRHT (forward and transpose)
// for NVIDIA Hopper (sm_90a), in float and double.
//
// Replaces the Pallas TPU kernels
//   fwht_pallas          (src/repro/kernels/fwht.py:51, body _fwht_kernel)
//   srht_apply_pallas    (src/repro/kernels/srht.py:98, body _srht_fwd_kernel)
//   srht_apply_t_pallas  (src/repro/kernels/srht.py:130, body _srht_t_kernel)
// The TPU bodies factor H_n into two small dense matmuls for the MXU and
// compute in float32. Here every kernel computes in the input type, so a
// double input stays double on Hopper's FP64 units.
//
// What bounds them: bytes. Per row the transform does n*log2(n) adds on
// n values, about one operation per byte moved, far below the card's
// ratio of peak FP64 rate to memory rate. On the main path (n = 32,
// millions of rows) the least time is the rows read plus the rows
// written over 3.35 TB/s; the transpose's main-path calls are a few rows,
// where the launch path on the host is all of the time.
//
// What the design does about it: each row crosses device memory once,
// and a stage costs no block barrier where the row fits a warp.
//   * fwht (fwht_reg_kernel): a thread holds 16 values, loaded and stored
//     as streaming 16-byte vectors with neighbouring lanes on neighbouring
//     vectors, all loads of a chunk issued before any arithmetic. The
//     stages run in registers and by warp shuffles, nine bits of the index
//     a phase; a row of n <= 2^9 needs one phase and no shared memory, a
//     longer one (to 2^14) crosses shared memory once between phases, in a
//     swizzled layout without bank conflicts. A block takes one chunk of
//     4096 values (one row past that).
//   * the forward SRHT of rows of 32 < n <= 2^14 (srht_fwd_reg_kernel):
//     the same register layout and phases, with lanes on consecutive
//     values. A chunk's R rows are one contiguous slab of R * dim values
//     in device memory; one 1-D bulk copy (cp.async.bulk, completing on
//     an mbarrier) brings its 16-byte-aligned middle into shared memory,
//     threads load the few values of its head and tail, and each thread
//     reads its 16 values from there, padding and flipping signs on the
//     way (the signs as bits in shared memory, built once an operator a
//     block, when every sign is +1 or -1; other signs are read as
//     values). The gather is a lookup in the inverse of the sampled
//     rows, also built once an operator a block: each thread stages only
//     its kept values, and the block stores the R x k outputs as one
//     coalesced run.
//   * the transpose of rows of n <= 1024 (srht_t_warp_kernel): a warp
//     holds a row, n/32 consecutive values a lane (32/n rows a warp below
//     32); the scaled scatter is a lookup in the inverse of the sampled
//     rows, built once per block; stages in registers and by shuffles.
//   * the forward SRHT of rows of n <= 32 (srht_fwd_warp_kernel): a warp
//     holds 32/n rows, one value per lane, runs the stages as shuffles
//     and gathers the k kept entries by a shuffle, with several rows in
//     flight per lane.
//   * longer rows of the transpose (srht_t_kernel): a block loads R rows
//     into shared memory (the scaled scatter applied on load), runs the
//     stages there with a barrier each (`butterfly`), and writes only
//     what the caller keeps.
//
// A row longer than kMaxN = 2^14 does not fit in a block's shared
// memory. It is transformed in passes that keep the stage order: first
// the low stages on contiguous chunks (h < 2^12 by fwht_reg_kernel for the
// plain transform, to 2^26, and less than 2^14 past that; h < 2^14 by
// `butterfly` for the SRHT forms), then the high stages along the strided
// axis of the row viewed as (n / lo, lo), up to 2^14 stages' worth of that
// axis a pass (one pass for n <= 2^28). In
// the strided pass (fwht_strided_kernel<T, LOG_R>) a warp takes 32
// consecutive columns, so every row of its tile is one coalesced run, and
// a lane holds its column's values in registers: all of them (and no
// shared memory) to 16 rows; past that four row bits a phase, with a
// shared-memory exchange between phases. The SRHT forms fold the
// padding and sign flip into the first pass's load (forward) or the
// scaled scatter into it (transpose), and finish with a gather (forward)
// or a sign flip and truncation (transpose) over the transformed rows in
// a scratch buffer the wrapper allocates.
//
// Op order follows repro.kernels.ref exactly (stages h = 1, 2, 4, ...;
// pairs (a + b, a - b); x 1/sqrt(n); then x sqrt(n/k) after the gather,
// or x sqrt(n/k) before the scatter for the transpose), and the scale
// factors come from the host already rounded to the input type. Built
// with -fmad=false, so no multiply is contracted into a later add: the
// results are bit-equal to the plain PyTorch version.
//
// The forward SRHT also takes one operator per group of rows (FedNS's and
// FedNDES's per-client sketches of srht_apply_pallas under jax.vmap, one
// launch for all clients): row r uses signs + (r / group) n and sel +
// (r / group) k on every route. The register route cuts each operator's
// rows into its own chunks and gives each block a run of consecutive
// chunks, so a block sets an operator up once and never carries one
// operator's setup into another's rows.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() after the launch. Besides the C interface,
// the library is the Python extension module repro_srht, whose functions
// of the same names take the same arguments (see the end of the file).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "pymodule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockValues = 4096;  // values of T a block holds (rows * n)
constexpr int kLogMaxN = 14;
constexpr int kMaxN = 1 << kLogMaxN;  // n * 8 bytes = 128 KB of shared memory; SINGLE_PASS_N in fwht.py
// the low pass of a longer plain transform: fwht_reg_kernel on chunks of
// 2^kLogLowN (three blocks a SM; at 2^14 it holds one), then the strided
// pass; LOW_PASS_N in fwht.py
constexpr int kLogLowN = 12;
constexpr int kWarpN = 32;          // largest n of the register (warp) forward path
constexpr int kLogWarpN = 5;        // log2(kWarpN)
static_assert(kWarpN == 1 << kLogWarpN, "kLogWarpN");
constexpr int kWarpUnroll = 4;      // row groups a warp holds at once
constexpr int kLogRegs = 4;         // log2 of the values a thread of fwht_reg_kernel holds
constexpr int kLogMinWarps = 3;     // fwht_reg_kernel's least block: 8 warps
constexpr int kWarpTMaxN = 1024;    // largest n of the register transpose path (32 values a lane)
// srht_fwd_reg_kernel's grid. A block a chunk for rows of n < kFwdWaveN,
// where a block's setup (the inverse of sel, the signs' bits) is a small
// share of a chunk; from there, where the setup reads as many values as
// the chunk holds, one wave of resident blocks walking runs of chunks (the
// two were timed against each other on the H100, PERF.md).
constexpr int kFwdWaveN = 4096;

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

inline int rows_per_block(int n) { return n >= kBlockValues ? 1 : kBlockValues / n; }

// log2(n) in-place stages over R rows of length n held in shared memory.
template <typename T>
__device__ void butterfly(T* buf, int rows, int log_n) {
  if (log_n == 0) {  // n = 1: the transform is the identity
    __syncthreads();
    return;
  }
  const int half = 1 << (log_n - 1);
  const int pairs = rows * half;
  for (int log_h = 0; log_h < log_n; ++log_h) {
    const int h = 1 << log_h;
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p >> (log_n - 1);
      const int q = p & (half - 1);
      const int a = (r << log_n) + ((q >> log_h) << (log_h + 1)) + (q & (h - 1));
      const T va = buf[a];
      const T vb = buf[a + h];
      buf[a] = va + vb;
      buf[a + h] = va - vb;
    }
  }
  __syncthreads();
}

// Forward SRHT for n <= 32 in registers: lane l holds coordinate
// j = l % n of row slot l / n; stage h pairs lanes l and l ^ h, the lower
// one (bit h clear) keeping a + b and the upper one a - b, exactly the
// shared-memory butterfly's arithmetic. Row r takes operator r / group
// (signs + (r / group) n, sel + (r / group) k); with one operator
// (BATCHED false) a lane reads its sign and its gather source once.
template <typename T, bool BATCHED>
__global__ void srht_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                                     const int64_t* __restrict__ sel, T* __restrict__ out,
                                     long long nrows, long long group, int dim, int log_n,
                                     int k, T norm, T scale) {
  const int n = 1 << log_n;
  const int lane = threadIdx.x & 31;
  const int j = lane & (n - 1);
  const int slot = lane >> log_n;
  const int per_warp = 32 >> log_n;
  // the lane whose value output entry j of this lane's row takes, by the
  // operator's sel
  const auto source = [&](const int64_t* s) {
    return (lane & ~(n - 1)) + (j < k ? (int)s[j] : 0);
  };
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long row0 = warp * per_warp * kWarpUnroll + slot;
  T v[kWarpUnroll];
  int src[kWarpUnroll];
  if constexpr (BATCHED) {
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const long long row = row0 + (long long)u * per_warp;
      const long long g = min(row, nrows - 1) / group;
      src[u] = source(sel + g * k);
      const T val = (j < dim && row < nrows) ? x[row * dim + j] : T(0);
      v[u] = val * signs[(g << log_n) + j];
    }
  } else {
    const T sign = signs[j];
    src[0] = source(sel);
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const long long row = row0 + (long long)u * per_warp;
      const T val = (j < dim && row < nrows) ? x[row * dim + j] : T(0);
      v[u] = val * sign;
    }
  }
  for (int h = 1; h < n; h <<= 1) {
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const T p = __shfl_xor_sync(0xffffffffu, v[u], h);
      v[u] = (j & h) ? p - v[u] : v[u] + p;
    }
  }
#pragma unroll
  for (int u = 0; u < kWarpUnroll; ++u) {
    const T g = __shfl_sync(0xffffffffu, v[u], src[BATCHED ? u : 0]) * norm;
    const long long row = row0 + (long long)u * per_warp;
    if (j < k && row < nrows) out[row * k + j] = g * scale;
  }
}

template <typename T>
__global__ void srht_t_kernel(const T* __restrict__ y, const T* __restrict__ signs,
                              const int64_t* __restrict__ sel, T* __restrict__ out,
                              long long nrows, int dim, int log_n, int k, int rpb,
                              T norm, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << log_n;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int rows = (int)min((long long)rpb, nrows - r0);
  const int count = rows * n;
  for (int e = threadIdx.x; e < count; e += blockDim.x) buf[e] = T(0);
  __syncthreads();
  // scatter the scaled k entries into the zeroed padded domain; the
  // sampled rows are distinct, so every write hits its own slot
  const T* src = y + r0 * k;
  const int ins = rows * k;
  for (int e = threadIdx.x; e < ins; e += blockDim.x) {
    const int r = e / k;
    const int c = e - r * k;
    buf[(r << log_n) + (int)sel[c]] = src[e] * scale;
  }
  butterfly(buf, rows, log_n);
  T* dst = out + r0 * dim;
  const int outs = rows * dim;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int r = e / dim;
    const int j = e - r * dim;
    const T h = buf[(r << log_n) + j] * norm;
    dst[e] = h * signs[j];
  }
}

// ---------------------------------------------------------------------------
// Register butterflies: the stages run in registers and by warp shuffles;
// shared memory only exchanges values between groups of stages.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// V values of T that move as one 16-, 8- or 4-byte access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Streaming (evict-first) accesses for data read once and written once. The
// 16-byte forms are volatile asm, so the compiler issues a thread's loads
// where they stand, all before the arithmetic, instead of sinking each to
// its first use.
template <typename VT>
__device__ __forceinline__ VT load_cs(const VT* p) {
  if constexpr (sizeof(VT) == 16) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
    VT t;
    memcpy(&t, &r, sizeof(t));
    return t;
  } else if constexpr (std::is_floating_point_v<VT>) {
    return __ldcs(p);
  } else {
    return *p;
  }
}

template <typename VT>
__device__ __forceinline__ void store_cs(VT* p, const VT& t) {
  if constexpr (sizeof(VT) == 16) {
    float4 r;
    memcpy(&r, &t, sizeof(r));
    __stcs(reinterpret_cast<float4*>(p), r);
  } else if constexpr (std::is_floating_point_v<VT>) {
    __stcs(p, t);
  } else {
    *p = t;
  }
}

// threadIdx.x read anew (volatile): offsets computed from it cannot be
// merged with ones computed earlier, so a kernel that reads it again
// before its stores recomputes their offsets there instead of keeping the
// loads' offsets in registers through the stages.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The stage whose pairs are registers u and u + h of one thread (h a power
// of two, bit h of u clear): the lower keeps a + b, the upper a - b.
template <typename T, int Q>
__device__ __forceinline__ void reg_stage(T (&v)[Q], int h) {
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    if (!(u & h)) {
      const T a = v[u];
      const T b = v[u + h];
      v[u] = a + b;
      v[u + h] = a - b;
    }
  }
}

// The stage whose pairs are lanes l and l ^ m of a warp (m a power of two
// below 32), register by register: the lane with bit m clear holds the
// lower coordinate and keeps a + b, its partner a - b.
template <typename T, int Q>
__device__ __forceinline__ void lane_stage(T (&v)[Q], int m, int lane) {
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const T p = __shfl_xor_sync(0xffffffffu, v[u], m);
    v[u] = (lane & m) ? p - v[u] : v[u] + p;
  }
}

// fwht_reg_kernel's layout. A block transforms chunks of C = 2^kLogC values
// (whole rows: C >= n) with W = 2^kLogW warps, each thread holding Q = 16
// values in registers. A chunk's index bits are covered in phases of
// kPhaseBits = 9 bits: phase p runs the stages of bits [9p, min(9p + 9,
// log n)) in a layout based at bit m = min(9p, kLogW) (`reg_index`), where
// those bits sit in the thread's registers and its lane. Between phases the
// values cross shared memory once (`swizzle`d); a row of n <= 2^9 needs one
// phase and no shared memory at all.
template <typename T, int LOG_N, int LOG_V = cmin(sizeof(T) == 8 ? 1 : 2, LOG_N)>
struct RegFwht {
  static constexpr int kLogV = LOG_V;  // by default a 16-byte load (less for n < that)
  static constexpr int kLogQ = kLogRegs;
  static constexpr int kPhaseBits = kLogQ + 5;
  static constexpr int kLogC = cmax(LOG_N, kPhaseBits + kLogMinWarps);
  static constexpr int kLogW = kLogC - kPhaseBits;
  static constexpr int kThreads = 32 << kLogW;
  static constexpr int kPhases = LOG_N <= kPhaseBits ? 1 : (LOG_N + kPhaseBits - 1) / kPhaseBits;
  static constexpr int kLastBase = cmin((kPhases - 1) * kPhaseBits, kLogW);
  static constexpr size_t kSmem = kPhases > 1 ? ((size_t)1 << kLogC) * sizeof(T) : 0;
};

// Chunk index of register u of lane `lane` in warp w, in the layout based at
// bit m: register bits [0, LOG_V) -> index bits [m, m + LOG_V), the lane ->
// the next 5 bits, the other register bits -> the next LOG_Q - LOG_V bits;
// the warp fills the index bits below m and above m + PHASE_BITS. At m = 0
// a thread's LOG_V low registers are consecutive values and neighbouring
// lanes hold neighbouring vectors, so loads and stores coalesce.
template <int LOG_V, int PHASE_BITS>
__device__ __forceinline__ int reg_index(int m, int w, int lane, int u) {
  const int f = (u & ((1 << LOG_V) - 1)) | (lane << LOG_V) | ((u >> LOG_V) << (LOG_V + 5));
  return (w & ((1 << m) - 1)) | (f << m) | ((w >> m) << (m + PHASE_BITS));
}

// Shared-memory slot of chunk index e: the low G bits are XORed with every
// higher G-bit group of e (G = 4 for 8-byte values, whose banks come in 16
// pairs; 5 for 4-byte values), so the lanes of a (half-)warp that differ in
// any G consecutive index bits fall in distinct banks.
template <typename T, int LOG_C>
__device__ __forceinline__ int swizzle(int e) {
  constexpr int G = sizeof(T) == 8 ? 4 : 5;
  int x = 0;
#pragma unroll
  for (int s = G; s < LOG_C; s += G) x ^= e >> s;
  return e ^ (x & ((1 << G) - 1));
}

template <typename T, int LOG_V, int PHASE_BITS, int LOG_C, int Q>
__device__ __forceinline__ void exchange(T* s, T (&v)[Q], int w, int lane, int from, int to) {
  // w and lane pass through an empty asm, so the 2Q slots are computed at
  // each exchange, not held in registers across the chunk loop (fewer
  // registers, more resident blocks)
  asm volatile("" : "+r"(w), "+r"(lane));
  __syncthreads();  // every read of the previous exchange is done
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    s[swizzle<T, LOG_C>(reg_index<LOG_V, PHASE_BITS>(from, w, lane, u))] = v[u];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    v[u] = s[swizzle<T, LOG_C>(reg_index<LOG_V, PHASE_BITS>(to, w, lane, u))];
  }
}

// The stages of rows of 2^LOG_N values held in registers in L's layout
// based at bit 0 (L = RegFwht<T, LOG_N, LOG_V>), phase by phase, crossing
// the shared memory s between phases; the values end in the last phase's
// layout (based at bit L::kLastBase).
template <typename L, int LOG_N, typename T, int Q>
__device__ __forceinline__ void reg_phases(T* s, T (&v)[Q], int w, int lane) {
  constexpr int kLogV = L::kLogV;
  constexpr int kBits = L::kPhaseBits;
#pragma unroll
  for (int p = 0; p < L::kPhases; ++p) {
    const int m = cmin(p * kBits, L::kLogW);
    if (p > 0) {
      exchange<T, kLogV, kBits, L::kLogC>(s, v, w, lane, cmin((p - 1) * kBits, L::kLogW), m);
    }
#pragma unroll
    for (int b = p * kBits; b < cmin((p + 1) * kBits, LOG_N); ++b) {
      const int t = b - m;  // the bit's place in the phase's layout
      if (t < kLogV) {
        reg_stage(v, 1 << t);
      } else if (t < kLogV + 5) {
        lane_stage(v, 1 << (t - kLogV), lane);
      } else {
        reg_stage(v, 1 << (t - 5));
      }
    }
  }
}

// WHT of rows of n = 2^LOG_N <= kMaxN values, nvec vectors of 2^kLogV
// values in all, the chunks taken in a grid-stride loop (one chunk a block
// where the grid allows). A thread issues all its loads of a chunk (Q / V
// vectors) before any arithmetic.
template <typename T, int LOG_N>
__global__ void __launch_bounds__(RegFwht<T, LOG_N>::kThreads)
fwht_reg_kernel(const T* __restrict__ x, T* __restrict__ out, long long nvec, T norm) {
  using L = RegFwht<T, LOG_N>;
  constexpr int kLogV = L::kLogV;
  constexpr int V = 1 << kLogV;
  constexpr int Q = 1 << L::kLogQ;
  constexpr int kBits = L::kPhaseBits;
  constexpr int kChunkVecs = 1 << (L::kLogC - kLogV);
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* ov = reinterpret_cast<VT*>(out);
  const long long nchunks = (nvec + kChunkVecs - 1) / kChunkVecs;
  for (long long chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    int lane = fresh_tid() & 31;
    int w = fresh_tid() >> 5;
    const long long v0 = chunk * kChunkVecs;
    T v[Q];
#pragma unroll
    for (int g = 0; g < Q / V; ++g) {
      const long long vi = v0 + (reg_index<kLogV, kBits>(0, w, lane, g * V) >> kLogV);
      VT t = {};
      if (vi < nvec) t = load_cs(xv + vi);
#pragma unroll
      for (int i = 0; i < V; ++i) v[g * V + i] = t.v[i];
    }
    reg_phases<L, LOG_N>(s, v, w, lane);
    if (L::kPhases > 1) exchange<T, kLogV, kBits, L::kLogC>(s, v, w, lane, L::kLastBase, 0);
    lane = fresh_tid() & 31;  // the stores' offsets are computed here
    w = fresh_tid() >> 5;
#pragma unroll
    for (int g = 0; g < Q / V; ++g) {
      const long long vi = v0 + (reg_index<kLogV, kBits>(0, w, lane, g * V) >> kLogV);
      VT t;
#pragma unroll
      for (int i = 0; i < V; ++i) t.v[i] = v[g * V + i] * norm;
      if (vi < nvec) store_cs(ov + vi, t);
    }
  }
}

// The 1-D bulk copy (TMA) and its mbarrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from the 16-byte-aligned src to the
// 16-byte-aligned shared address dst; the copy arrives on bar, which
// expects it. The block's earlier accesses of dst (generic proxy) are
// ordered before the copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The sign bit of v: 1 for -1, 0 for +1.
__device__ __forceinline__ unsigned sign_bit(double v) {
  return (unsigned)((unsigned long long)__double_as_longlong(v) >> 63);
}
__device__ __forceinline__ unsigned sign_bit(float v) { return (unsigned)__float_as_uint(v) >> 31; }

// srht_fwd_reg_kernel: fwht_reg_kernel's layout with lanes on consecutive
// values (LOG_V = 0), whose reads of the slab in shared memory are free of
// bank conflicts; a chunk holds kRows rows. Its shared memory: the
// mbarrier, the chunk (the slab as copied, at its offset from a 16-byte
// boundary, then the exchange between phases, then the staged outputs),
// the inverse of the sampled rows (n ints) and the signs' bits (n / 32
// words).
template <typename T, int LOG_N>
struct SrhtFwdReg {
  using L = RegFwht<T, LOG_N, 0>;
  static constexpr int kRows = 1 << (L::kLogC - LOG_N);
  static constexpr size_t kChunk = 16;
  static constexpr size_t kInv = kChunk + ((size_t)1 << L::kLogC) * sizeof(T) + 16;
  static constexpr size_t kNeg = kInv + ((size_t)sizeof(int) << LOG_N);
  static constexpr size_t kSmem = kNeg + ((size_t)sizeof(uint32_t) << (LOG_N - 5));
};

// Forward SRHT of rows of 32 < n = 2^LOG_N <= kMaxN (dim values each,
// dim <= n) in chunks of at most R = kRows rows. One operator (BATCHED
// false): nrows rows in nchunks chunks taken in a grid-stride loop, the
// operator set up once a block (the inverse of sel and the signs' bits).
// G operators (BATCHED true): row r takes operator r / group (signs +
// (r / group) n, sel + (r / group) k); an operator's group rows are cut
// into chunks_per_op chunks, so no chunk straddles two operators (an
// operator's last chunk may be short), and nchunks = G chunks_per_op.
// Below kFwdWaveN a block takes one chunk (chunk b) and sets its operator
// up; from there block b of the wave takes the consecutive chunks
// [b nchunks / grid, (b + 1) nchunks / grid): it walks one operator's
// chunks before the next's and sets each up once, where a grid-stride
// walk would set one up at every chunk.
// A chunk: the slab of its rows' values by one bulk copy (and at most 15
// bytes at each end by plain loads); each register takes its value, zero
// past dim, times its sign (+1 or -1 by its bit); the stages
// (reg_phases); each kept value, x norm x scale, into the chunk's rows x k
// outputs staged in shared memory; one coalesced store.
// When every sign of the operator is +1 or -1 (the Rademacher draws of the
// samplers) a sign is taken from its bit; otherwise each value is
// multiplied by its sign read from device memory, so any signs give the
// plain version's result.
template <typename T, int LOG_N, bool BATCHED>
__global__ void __launch_bounds__(SrhtFwdReg<T, LOG_N>::L::kThreads,
                                  1024 / SrhtFwdReg<T, LOG_N>::L::kThreads)
srht_fwd_reg_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                    const int64_t* __restrict__ sel, T* __restrict__ out, long long nrows,
                    long long group, int chunks_per_op, int nchunks, int dim, int k, T norm,
                    T scale) {
  using S = SrhtFwdReg<T, LOG_N>;
  using L = typename S::L;
  constexpr int n = 1 << LOG_N;
  constexpr int Q = 1 << L::kLogQ;
  constexpr int kBits = L::kPhaseBits;
  constexpr int kThreads = L::kThreads;
  constexpr int kAlign = 16 / sizeof(T);  // values of a 16-byte granule
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t bar = smem_addr(smem_raw);
  T* chunk = reinterpret_cast<T*>(smem_raw + S::kChunk);
  int* inv = reinterpret_cast<int*>(smem_raw + S::kInv);
  uint32_t* neg = reinterpret_cast<uint32_t*>(smem_raw + S::kNeg);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) mbar_init(bar);  // made visible by the first setup's barriers
  // operator g into shared memory: the inverse of its sel and its signs'
  // bits; returns whether every sign is +1 or -1
  const auto set_up = [&](int g) {
    const T* op_signs = signs + ((long long)g << LOG_N);
    const int64_t* op_sel = sel + (long long)g * k;
    int unit = 1;  // this thread's signs are all +1 or -1
    for (int j = tid; j < n; j += kThreads) {  // whole warps: n is a multiple of 32
      inv[j] = -1;
      const T s = op_signs[j];
      unit &= (s == T(1)) | (s == T(-1));
      const unsigned bits = __ballot_sync(0xffffffffu, sign_bit(s));
      if (lane == 0) neg[j >> 5] = bits;
    }
    const bool all_unit = __syncthreads_and(unit);
    for (int c = tid; c < k; c += kThreads) inv[(int)op_sel[c]] = c;
    __syncthreads();
    return all_unit;
  };
  // chunk ci: its first row r0 and its rows
  const auto span = [&](int ci, long long& r0, int& rows) {
    if constexpr (BATCHED) {
      const int g = ci / chunks_per_op;
      const long long r_in = (long long)(ci - g * chunks_per_op) * S::kRows;
      r0 = (long long)g * group + r_in;
      rows = (int)min((long long)S::kRows, group - r_in);
    } else {
      r0 = (long long)ci * S::kRows;
      rows = (int)min((long long)S::kRows, nrows - r0);
    }
  };
  // chunk ci by its operator, set up in shared memory
  const auto transform = [&](int ci, bool by_bit, uint32_t parity) {
    long long r0;
    int rows;
    span(ci, r0, rows);
    const int count = rows * dim;  // values of the slab
    const T* src = x + r0 * dim;
    // the slab sits in shared memory at its offset from a 16-byte
    // boundary, so its aligned middle lands on one there too
    const int lead = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
    const int head = min(count, (kAlign - lead) & (kAlign - 1));
    const int body = (count - head) / kAlign * kAlign;
    T* slab = chunk + lead;
    if (tid == 0) {
      if (body > 0) {
        bulk_load(smem_addr(slab + head), src + head, (uint32_t)(body * sizeof(T)), bar);
      } else {
        mbar_arrive(bar);
      }
    }
    if (tid < head) slab[tid] = src[tid];
    if (tid >= 32 && tid - 32 < count - head - body) {
      const int i = head + body + tid - 32;
      slab[i] = src[i];
    }
    mbar_wait(bar, parity);
    __syncthreads();  // the head and tail
    // the registers' offsets, computed in each chunk (fresh_tid), not held
    // in registers across the loop
    int l = fresh_tid() & 31;
    int w = fresh_tid() >> 5;
    T v[Q];
    // zero-pad to n, then flip signs: padding becomes 0 * sign, as in the
    // reference's pad-then-multiply; the branch is the block's, outside
    // the loop
    const auto load = [&](auto sign_of) {
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int e = reg_index<0, kBits>(0, w, l, u);
        const int r = e >> LOG_N;
        const int j = e & (n - 1);
        const T val = (j < dim && r < rows) ? slab[r * dim + j] : T(0);
        v[u] = val * sign_of(j);
      }
    };
    if (by_bit) {
      load([&](int j) { return ((neg[j >> 5] >> (j & 31)) & 1u) ? T(-1) : T(1); });
    } else {
      const T* op_signs = BATCHED ? signs + ((long long)(ci / chunks_per_op) << LOG_N) : signs;
      load([&](int j) { return op_signs[j]; });
    }
    reg_phases<L, LOG_N>(chunk, v, w, l);
    __syncthreads();  // every read of the slab or of the last exchange is done
    if constexpr (BATCHED) {
      // the store's rows recomputed from an opaque copy of ci, not held in
      // registers through the stages
      int cj = ci;
      asm volatile("" : "+r"(cj));
      span(cj, r0, rows);
    }
    l = fresh_tid() & 31;
    w = fresh_tid() >> 5;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int e = reg_index<0, kBits>(L::kLastBase, w, l, u);
      const int c = inv[e & (n - 1)];
      if (c >= 0) {
        const T h = v[u] * norm;
        chunk[(e >> LOG_N) * k + c] = h * scale;
      }
    }
    __syncthreads();
    T* dst = out + r0 * k;
    const int outs = rows * k;
    for (int i = tid; i < outs; i += kThreads) store_cs(dst + i, chunk[i]);
    __syncthreads();  // the staged outputs are read before the next copy
  };
  uint32_t parity = 0;
  if constexpr (!BATCHED) {
    const bool by_bit = set_up(0);
    for (int ci = blockIdx.x; ci < nchunks; ci += gridDim.x, parity ^= 1) {
      transform(ci, by_bit, parity);
    }
  } else if constexpr (n < kFwdWaveN) {  // a block a chunk
    transform(blockIdx.x, set_up(blockIdx.x / chunks_per_op), 0);
  } else {  // the wave: a run of chunks a block
    const int first = (int)((long long)blockIdx.x * nchunks / gridDim.x);
    const int last = (int)((long long)(blockIdx.x + 1) * nchunks / gridDim.x);
    bool by_bit = set_up(first / chunks_per_op);
    for (int ci = first; ci < last; ++ci, parity ^= 1) {
      transform(ci, by_bit, parity);
      // the block's (uniform) switch to the next chunk's operator; the
      // chunk's last barrier ended every read of inv and neg
      const int next = ci + 1;
      if (next < last && next % chunks_per_op == 0) by_bit = set_up(next / chunks_per_op);
    }
  }
}

// Transpose SRHT of rows of n = 2^log_n <= kWarpTMaxN in registers: lane l
// holds the P = 2^LOG_P consecutive coordinates j = (l % L) P + i of row
// slot l / L, L = n / P lanes to a row. The scaled scatter is a lookup in
// the inverse of sel, which each block builds once; then the stages (the
// low LOG_P in registers, the rest by shuffles), x norm, x signs, and the
// store of j < dim. Warps take row groups in a grid-stride loop.
template <typename T, int LOG_P>
__global__ void __launch_bounds__(kThreads)
srht_t_warp_kernel(const T* __restrict__ y, const T* __restrict__ signs,
                   const int64_t* __restrict__ sel, T* __restrict__ out, long long nrows,
                   int dim, int log_n, int k, T norm, T scale) {
  constexpr int P = 1 << LOG_P;
  __shared__ int inv[kWarpTMaxN];
  const int n = 1 << log_n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) inv[j] = -1;
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) inv[sel[c]] = c;
  __syncthreads();
  const int log_l = log_n - LOG_P;
  const int lane = threadIdx.x & 31;
  const int q = lane & ((1 << log_l) - 1);
  const int per_warp = 32 >> log_l;
  const int slot = lane >> log_l;
  int src[P];
  T sign[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    src[i] = inv[q * P + i];
    sign[i] = signs[q * P + i];
  }
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per_warp;
       row0 < nrows; row0 += warps * per_warp) {
    const long long row = row0 + slot;
    const bool live = row < nrows;
    T v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      v[i] = (live && src[i] >= 0) ? y[row * k + src[i]] * scale : T(0);
    }
#pragma unroll
    for (int h = 1; h < P; h <<= 1) reg_stage(v, h);
    for (int m = 1; m < (1 << log_l); m <<= 1) lane_stage(v, m, lane);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = q * P + i;
      const T h = v[i] * norm;
      if (live && j < dim) out[row * dim + j] = h * sign[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Rows longer than kMaxN: the low stages on contiguous chunks of kMaxN, then
// the high stages along the strided axis.
// ---------------------------------------------------------------------------

// First pass of a long forward SRHT row: block b holds chunk b % chunks of
// row r = b / chunks, padded and flipped on load by the signs of its
// operator r / group, runs the low stages and writes the chunk whole.
template <typename T>
__global__ void srht_fwd_low_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                                    T* __restrict__ buf, long long group, int dim, int log_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int log_chunks = log_n - kLogMaxN;
  const long long r = (long long)blockIdx.x >> log_chunks;
  const long long j0 = ((long long)blockIdx.x & ((1LL << log_chunks) - 1)) << kLogMaxN;
  const T* src = x + r * dim;
  const T* sg = signs + ((r / group) << log_n);
  for (int e = threadIdx.x; e < kMaxN; e += blockDim.x) {
    const long long j = j0 + e;
    const T v = j < dim ? src[j] : T(0);
    s[e] = v * sg[j];
  }
  butterfly(s, 1, kLogMaxN);
  T* dst = buf + (r << log_n) + j0;
  for (int e = threadIdx.x; e < kMaxN; e += blockDim.x) dst[e] = s[e];
}

// First pass of a long transpose row: the chunk is zeroed, the scaled
// entries whose sampled row falls in it are scattered, then the low stages.
template <typename T>
__global__ void srht_t_low_kernel(const T* __restrict__ y, const int64_t* __restrict__ sel,
                                  T* __restrict__ buf, int log_n, int k, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int log_chunks = log_n - kLogMaxN;
  const long long r = (long long)blockIdx.x >> log_chunks;
  const long long j0 = ((long long)blockIdx.x & ((1LL << log_chunks) - 1)) << kLogMaxN;
  for (int e = threadIdx.x; e < kMaxN; e += blockDim.x) s[e] = T(0);
  __syncthreads();
  const T* src = y + r * k;
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    const long long j = sel[c] - j0;
    if (j >= 0 && j < kMaxN) s[j] = src[c] * scale;
  }
  butterfly(s, 1, kLogMaxN);
  T* dst = buf + (r << log_n) + j0;
  for (int e = threadIdx.x; e < kMaxN; e += blockDim.x) dst[e] = s[e];
}

// fwht_strided_kernel's layout for LOG_R strided stages (h = lo, 2 lo,
// ..., lo 2^(LOG_R - 1)): a tile is 2^LOG_R rows of the strided axis by
// 2^kLogCols consecutive columns, index e = row * 2^kLogCols + column. A
// lane holds e's low 5 bits, 32 consecutive columns where the tile is that
// wide (every LOG_R <= 9), so every access of a warp is one contiguous run;
// registers hold kLogQ of the bits above, the tile's warps the others.
// Phase p holds in registers the bits [base, base + kLogQ) of e >> 5 (base
// = min(p kLogQ, kLogU - kLogQ)) and runs the stages of those it has not
// run yet; phases cross shared memory, where the lanes of a warp touch
// consecutive values (no bank conflicts). To 16 rows a lane holds its
// column whole: one phase, no shared memory, a warp a tile and 8 tiles a
// block.
template <int LOG_R>
struct StridedFwht {
  static constexpr int kLogQ = cmin(LOG_R, kLogRegs);
  static constexpr int kLogCols = LOG_R <= kLogRegs + 5 ? 5 : kLogMaxN - LOG_R;
  static constexpr int kLogU = LOG_R + kLogCols - 5;  // index bits above the lane's
  static constexpr int kLogW = kLogU - kLogQ;         // warps of a tile
  static constexpr int kPhases = (kLogU + kLogQ - 1) / kLogQ;
  static constexpr int kTiles = kLogW == 0 ? 8 : 1;   // tiles of a block
  static constexpr int kThreads = (32 << kLogW) * kTiles;
  static constexpr size_t kSmemValues = kPhases > 1 ? (size_t)1 << (LOG_R + kLogCols) : 0;
};

// Tile index of register u of lane `lane` in warp w of the tile, in the
// layout whose registers hold the bits [base, base + LOG_Q) of e >> 5.
template <int LOG_Q>
__device__ __forceinline__ int strided_index(int base, int w, int lane, int u) {
  return lane | (((w & ((1 << base) - 1)) | (u << base) | ((w >> base) << (base + LOG_Q))) << 5);
}

// The LOG_R strided stages of buf viewed as (groups, 2^LOG_R, lo = 2^log_lo),
// in place, a tile a block (8 tiles to 16 rows); all loads of a thread are
// issued before any arithmetic. The results are scaled by norm as they are
// written (1 but on the last pass of a normalized transform).
template <typename T, int LOG_R>
__global__ void __launch_bounds__(StridedFwht<LOG_R>::kThreads)
fwht_strided_kernel(T* __restrict__ buf, int log_lo, T norm) {
  using L = StridedFwht<LOG_R>;
  constexpr int Q = 1 << L::kLogQ;
  constexpr int kCols = 1 << L::kLogCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & ((1 << L::kLogW) - 1);
  const long long tile = (long long)blockIdx.x * L::kTiles + (threadIdx.x >> (5 + L::kLogW));
  const int log_tiles = log_lo - L::kLogCols;  // column tiles of a group
  const long long g = tile >> log_tiles;
  const long long c0 = (tile & ((1LL << log_tiles) - 1)) << L::kLogCols;
  T* base = buf + (g << (log_lo + LOG_R)) + c0;
  T v[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int e = strided_index<L::kLogQ>(0, w, lane, u);
    v[u] = load_cs(base + ((long long)(e >> L::kLogCols) << log_lo) + (e & (kCols - 1)));
  }
  // row bits held by lanes (tiles narrower than 32 columns): run first,
  // as the lowest stages, by shuffles
#pragma unroll
  for (int b = L::kLogCols; b < 5; ++b) lane_stage(v, 1 << b, lane);
#pragma unroll
  for (int p = 0; p < L::kPhases; ++p) {
    const int at = cmin(p * L::kLogQ, L::kLogU - L::kLogQ);
    if (p > 0) {
      const int from = cmin((p - 1) * L::kLogQ, L::kLogU - L::kLogQ);
      __syncthreads();  // every read of the previous exchange is done
#pragma unroll
      for (int u = 0; u < Q; ++u) s[strided_index<L::kLogQ>(from, w, lane, u)] = v[u];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < Q; ++u) v[u] = s[strided_index<L::kLogQ>(at, w, lane, u)];
    }
#pragma unroll
    for (int b = p * L::kLogQ; b < cmin((p + 1) * L::kLogQ, L::kLogU); ++b) {
      reg_stage(v, 1 << (b - at));
    }
  }
  constexpr int kLast = cmin((L::kPhases - 1) * L::kLogQ, L::kLogU - L::kLogQ);
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int e = strided_index<L::kLogQ>(kLast, w, lane, u);
    store_cs(base + ((long long)(e >> L::kLogCols) << log_lo) + (e & (kCols - 1)),
             T(v[u] * norm));
  }
}

// The gather of a long forward SRHT row r through the sel of its
// operator r / group.
template <typename T>
__global__ void srht_gather_kernel(const T* __restrict__ buf, const int64_t* __restrict__ sel,
                                   T* __restrict__ out, long long nrows, long long group,
                                   int log_n, int k, T norm, T scale) {
  const long long total = nrows * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / k;
    const int c = (int)(e - r * k);
    const T h = buf[(r << log_n) + sel[(r / group) * k + c]] * norm;
    out[e] = h * scale;
  }
}

template <typename T>
__global__ void srht_t_finish_kernel(const T* __restrict__ buf, const T* __restrict__ signs,
                                     T* __restrict__ out, long long nrows, int dim, int log_n,
                                     T norm) {
  const long long total = nrows * dim;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / dim;
    const int j = (int)(e - r * dim);
    const T h = buf[(r << log_n) + j] * norm;
    out[e] = h * signs[j];
  }
}

// Launch geometry of srht_t_kernel: grid, rows per block and dynamic
// shared memory, with the opt-in above 48 KB.
template <typename Kernel>
cudaError_t configure(Kernel kernel, long long nrows, int n, size_t elem,
                      int* rpb, unsigned* blocks, size_t* smem) {
  if (n < 1 || n > kMaxN || (n & (n - 1)) != 0 || nrows <= 0) return cudaErrorInvalidValue;
  *rpb = rows_per_block(n);
  *blocks = (unsigned)((nrows + *rpb - 1) / *rpb);
  *smem = (size_t)(*rpb) * n * elem;
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  }
  return cudaSuccess;
}

// Opt in to more than 48 KB of dynamic shared memory where asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool long_row(long long nrows, int n) {
  return nrows > 0 && n > kMaxN && (n & (n - 1)) == 0 &&
         (nrows << (log2_int(n) - kLogMaxN)) <= 0x7fffffffLL;
}

// One strided pass: the stages h = 2^log_lo ... 2^(log_lo + log_r - 1) of
// nrows rows of 2^log_n in buf.
template <typename T, int LOG_R = 1>
cudaError_t strided_pass(T* buf, long long nrows, int log_n, int log_lo, int log_r, T norm,
                         cudaStream_t stream) {
  if constexpr (LOG_R > kLogMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (log_r != LOG_R) {
      return strided_pass<T, LOG_R + 1>(buf, nrows, log_n, log_lo, log_r, norm, stream);
    }
    using L = StridedFwht<LOG_R>;
    const size_t smem = L::kSmemValues * sizeof(T);
    cudaError_t err = allow_smem(fwht_strided_kernel<T, LOG_R>, smem);
    if (err != cudaSuccess) return err;
    const long long tiles = (nrows << (log_n - log_lo - LOG_R)) << (log_lo - L::kLogCols);
    const long long blocks = tiles / L::kTiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    fwht_strided_kernel<T, LOG_R><<<(unsigned)blocks, L::kThreads, smem, stream>>>(buf, log_lo,
                                                                                norm);
    return cudaGetLastError();
  }
}

// The high stages (h >= 2^log_lo) of nrows rows of length 2^log_n held in
// buf, in place, in passes of at most kLogMaxN stages; the last pass
// scales by norm.
template <typename T>
cudaError_t high_stages(T* buf, long long nrows, int log_n, int log_lo, T norm,
                        cudaStream_t stream) {
  while (log_lo < log_n) {
    const int log_r = std::min(log_n - log_lo, kLogMaxN);
    const bool last = log_lo + log_r == log_n;
    const cudaError_t err =
        strided_pass<T>(buf, nrows, log_n, log_lo, log_r, last ? norm : T(1), stream);
    if (err != cudaSuccess) return err;
    log_lo += log_r;
  }
  return cudaSuccess;
}

inline unsigned elementwise_blocks(long long total) {
  return (unsigned)std::max(1LL, std::min((total + kThreads - 1) / kThreads, 1LL << 20));
}

// SMs of the current card, queried once per card
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = std::max(count, 1);
  }
  return sms[dev];
}

// fwht_reg_kernel over nrows rows of 2^LOG_N: a block per chunk (a grid of
// one wave of resident blocks walking the chunks measured slower on the
// H100 at the main path's n = 32).
template <typename T, int LOG_N>
cudaError_t launch_fwht_reg(const T* x, T* out, long long nrows, T norm, cudaStream_t stream) {
  using L = RegFwht<T, LOG_N>;
  cudaError_t err = allow_smem(fwht_reg_kernel<T, LOG_N>, L::kSmem);
  if (err != cudaSuccess) return err;
  const long long chunks = ((nrows << LOG_N) + (1LL << L::kLogC) - 1) >> L::kLogC;
  fwht_reg_kernel<T, LOG_N><<<(unsigned)std::min(chunks, 0x7fffffffLL), L::kThreads, L::kSmem,
                              stream>>>(x, out, nrows << (LOG_N - L::kLogV), norm);
  return cudaGetLastError();
}

template <typename T, int LOG_N = 0>
cudaError_t fwht_reg(const T* x, T* out, long long nrows, int log_n, T norm,
                     cudaStream_t stream) {
  if constexpr (LOG_N > kLogMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (log_n == LOG_N) return launch_fwht_reg<T, LOG_N>(x, out, nrows, norm, stream);
    return fwht_reg<T, LOG_N + 1>(x, out, nrows, log_n, norm, stream);
  }
}

template <typename T>
cudaError_t launch_fwht(const T* x, T* out, long long nrows, int n, double norm,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (long_row(nrows, n)) {
    // low stages: x -> out in chunks of 2^log_lo (the register kernel at
    // n = 2^log_lo, unscaled); then the high stages, in one strided pass
    // to n = 2^28
    const int log_n = log2_int(n);
    const int log_lo = std::min(std::max(log_n - kLogMaxN, kLogLowN), kLogMaxN);
    const long long chunks = nrows << (log_n - log_lo);
    cudaError_t err = fwht_reg<T>(x, out, chunks, log_lo, T(1), s);
    if (err != cudaSuccess) return err;
    return high_stages(out, nrows, log_n, log_lo, (T)norm, s);
  }
  if (n < 1 || n > kMaxN || (n & (n - 1)) != 0 || nrows <= 0) return cudaErrorInvalidValue;
  return fwht_reg<T>(x, out, nrows, log2_int(n), (T)norm, s);
}

template <typename T, int LOG_N>
cudaError_t launch_srht_fwd_reg(const T* x, const T* signs, const int64_t* sel, T* out,
                                long long nrows, long long group, int dim, int k, T norm,
                                T scale, cudaStream_t stream) {
  using S = SrhtFwdReg<T, LOG_N>;
  const bool batched = group != nrows;
  const auto kernel =
      batched ? srht_fwd_reg_kernel<T, LOG_N, true> : srht_fwd_reg_kernel<T, LOG_N, false>;
  cudaError_t err = allow_smem(kernel, S::kSmem);
  if (err != cudaSuccess) return err;
  // an operator's rows in chunks of kRows, the last one short
  const long long per_op = (group + S::kRows - 1) / S::kRows;
  const long long chunks = nrows / group * per_op;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long blocks = chunks;
  if ((1 << LOG_N) >= kFwdWaveN) {
    static int resident[2] = {};  // blocks of each instantiation a SM holds
    if (resident[batched] == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[batched], kernel,
                                                          S::L::kThreads, S::kSmem);
      if (err != cudaSuccess) return err;
      resident[batched] = std::max(resident[batched], 1);
    }
    blocks = std::min(blocks, (long long)sm_count() * resident[batched]);
  }
  kernel<<<(unsigned)blocks, S::L::kThreads, S::kSmem, stream>>>(
      x, signs, sel, out, nrows, group, (int)per_op, (int)chunks, dim, k, norm, scale);
  return cudaGetLastError();
}

template <typename T, int LOG_N = kLogWarpN + 1>
cudaError_t srht_fwd_reg(const T* x, const T* signs, const int64_t* sel, T* out,
                         long long nrows, long long group, int dim, int log_n, int k, T norm,
                         T scale, cudaStream_t stream) {
  if constexpr (LOG_N > kLogMaxN) {
    return cudaErrorInvalidValue;
  } else {
    if (log_n == LOG_N) {
      return launch_srht_fwd_reg<T, LOG_N>(x, signs, sel, out, nrows, group, dim, k, norm,
                                           scale, stream);
    }
    return srht_fwd_reg<T, LOG_N + 1>(x, signs, sel, out, nrows, group, dim, log_n, k, norm,
                                      scale, stream);
  }
}

// nrows rows in operators of group rows each (one operator: group = nrows)
inline bool valid_groups(long long nrows, long long group) {
  return nrows > 0 && group > 0 && nrows % group == 0;
}

// Forward SRHT of nrows rows of n <= kMaxN, row r by operator r / group.
template <typename T>
cudaError_t launch_srht(const T* x, const T* signs, const int64_t* sel, T* out,
                        long long nrows, long long group, int dim, int n, int k,
                        double norm, double scale, void* stream) {
  if (n < 1 || n > kMaxN || (n & (n - 1)) != 0 || !valid_groups(nrows, group)) {
    return cudaErrorInvalidValue;
  }
  if (n <= kWarpN) {
    const long long rows_per_block = (long long)(kThreads / 32) * (32 / n) * kWarpUnroll;
    const unsigned blocks = (unsigned)((nrows + rows_per_block - 1) / rows_per_block);
    const auto kernel =
        group == nrows ? srht_fwd_warp_kernel<T, false> : srht_fwd_warp_kernel<T, true>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, signs, sel, out, nrows, group, dim, log2_int(n), k, (T)norm, (T)scale);
    return cudaGetLastError();
  }
  return srht_fwd_reg<T>(x, signs, sel, out, nrows, group, dim, log2_int(n), k, (T)norm,
                         (T)scale, (cudaStream_t)stream);
}

template <typename T, int LOG_P = 0>
void launch_srht_t_warp(unsigned blocks, cudaStream_t stream, int log_p, const T* y,
                        const T* signs, const int64_t* sel, T* out, long long nrows, int dim,
                        int log_n, int k, T norm, T scale) {
  if constexpr ((32 << LOG_P) <= kWarpTMaxN) {
    if (log_p != LOG_P) {
      launch_srht_t_warp<T, LOG_P + 1>(blocks, stream, log_p, y, signs, sel, out, nrows, dim,
                                       log_n, k, norm, scale);
      return;
    }
    srht_t_warp_kernel<T, LOG_P><<<blocks, kThreads, 0, stream>>>(
        y, signs, sel, out, nrows, dim, log_n, k, norm, scale);
  }
}

template <typename T>
cudaError_t launch_srht_t(const T* y, const T* signs, const int64_t* sel, T* out,
                          long long nrows, int dim, int n, int k, double norm,
                          double scale, void* stream) {
  if (n >= 1 && n <= kWarpTMaxN && (n & (n - 1)) == 0 && nrows > 0) {
    const int log_n = log2_int(n);
    const int log_p = std::max(0, log_n - 5);
    const long long rows_per_block = (long long)(kThreads / 32) * (32 >> (log_n - log_p));
    const long long blocks = std::min((nrows + rows_per_block - 1) / rows_per_block,
                                      (long long)sm_count() * (2048 / kThreads));
    launch_srht_t_warp<T>((unsigned)blocks, (cudaStream_t)stream, log_p, y, signs, sel, out,
                          nrows, dim, log_n, k, (T)norm, (T)scale);
    return cudaGetLastError();
  }
  int rpb;
  unsigned blocks;
  size_t smem;
  cudaError_t err = configure(srht_t_kernel<T>, nrows, n, sizeof(T), &rpb, &blocks, &smem);
  if (err != cudaSuccess) return err;
  srht_t_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      y, signs, sel, out, nrows, dim, log2_int(n), k, rpb, (T)norm, (T)scale);
  return cudaGetLastError();
}

// Forward SRHT of rows longer than kMaxN through the scratch rows buf
// (nrows, n): padded, sign-flipped low stages; high stages; gather; row r
// by operator r / group.
template <typename T>
cudaError_t launch_srht_large(const T* x, const T* signs, const int64_t* sel, T* out, T* buf,
                              long long nrows, long long group, int dim, int n, int k,
                              double norm, double scale, void* stream) {
  if (!long_row(nrows, n) || !valid_groups(nrows, group)) return cudaErrorInvalidValue;
  const int log_n = log2_int(n);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)kMaxN * sizeof(T);
  cudaError_t err = allow_smem(srht_fwd_low_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  srht_fwd_low_kernel<T><<<(unsigned)(nrows << (log_n - kLogMaxN)), kThreads, smem, s>>>(
      x, signs, buf, group, dim, log_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = high_stages(buf, nrows, log_n, kLogMaxN, T(1), s);
  if (err != cudaSuccess) return err;
  srht_gather_kernel<T><<<elementwise_blocks(nrows * k), kThreads, 0, s>>>(
      buf, sel, out, nrows, group, log_n, k, (T)norm, (T)scale);
  return cudaGetLastError();
}

// Transpose SRHT of rows longer than kMaxN through the scratch rows buf
// (nrows, n): scaled scatter and low stages; high stages; signs, truncate.
template <typename T>
cudaError_t launch_srht_t_large(const T* y, const T* signs, const int64_t* sel, T* out, T* buf,
                                long long nrows, int dim, int n, int k, double norm,
                                double scale, void* stream) {
  if (!long_row(nrows, n)) return cudaErrorInvalidValue;
  const int log_n = log2_int(n);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)kMaxN * sizeof(T);
  cudaError_t err = allow_smem(srht_t_low_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  srht_t_low_kernel<T><<<(unsigned)(nrows << (log_n - kLogMaxN)), kThreads, smem, s>>>(
      y, sel, buf, log_n, k, (T)scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = high_stages(buf, nrows, log_n, kLogMaxN, T(1), s);
  if (err != cudaSuccess) return err;
  srht_t_finish_kernel<T><<<elementwise_blocks(nrows * dim), kThreads, 0, s>>>(
      buf, signs, out, nrows, dim, log_n, (T)norm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

cudaError_t repro_fwht_f32(const float* x, float* out, long long nrows, int n,
                           double norm, void* stream) {
  return launch_fwht<float>(x, out, nrows, n, norm, stream);
}

cudaError_t repro_fwht_f64(const double* x, double* out, long long nrows, int n,
                           double norm, void* stream) {
  return launch_fwht<double>(x, out, nrows, n, norm, stream);
}

// The forward entry points take the rows of one operator, group: row r
// takes signs + (r / group) n and sel + (r / group) k; group = nrows is
// one operator for every row.
cudaError_t repro_srht_apply_f32(const float* x, const float* signs, const int64_t* sel,
                                 float* out, long long nrows, long long group, int dim,
                                 int n, int k, double norm, double scale, void* stream) {
  return launch_srht<float>(x, signs, sel, out, nrows, group, dim, n, k, norm, scale,
                            stream);
}

cudaError_t repro_srht_apply_f64(const double* x, const double* signs, const int64_t* sel,
                                 double* out, long long nrows, long long group, int dim,
                                 int n, int k, double norm, double scale, void* stream) {
  return launch_srht<double>(x, signs, sel, out, nrows, group, dim, n, k, norm, scale,
                             stream);
}

cudaError_t repro_srht_apply_t_f32(const float* y, const float* signs, const int64_t* sel,
                                   float* out, long long nrows, int dim, int n, int k,
                                   double norm, double scale, void* stream) {
  return launch_srht_t<float>(y, signs, sel, out, nrows, dim, n, k, norm, scale, stream);
}

cudaError_t repro_srht_apply_t_f64(const double* y, const double* signs, const int64_t* sel,
                                   double* out, long long nrows, int dim, int n, int k,
                                   double norm, double scale, void* stream) {
  return launch_srht_t<double>(y, signs, sel, out, nrows, dim, n, k, norm, scale, stream);
}

cudaError_t repro_srht_apply_large_f32(const float* x, const float* signs, const int64_t* sel,
                                       float* out, float* buf, long long nrows,
                                       long long group, int dim, int n, int k, double norm,
                                       double scale, void* stream) {
  return launch_srht_large<float>(x, signs, sel, out, buf, nrows, group, dim, n, k, norm,
                                  scale, stream);
}

cudaError_t repro_srht_apply_large_f64(const double* x, const double* signs,
                                       const int64_t* sel, double* out, double* buf,
                                       long long nrows, long long group, int dim, int n,
                                       int k, double norm, double scale, void* stream) {
  return launch_srht_large<double>(x, signs, sel, out, buf, nrows, group, dim, n, k, norm,
                                   scale, stream);
}

cudaError_t repro_srht_apply_t_large_f32(const float* y, const float* signs,
                                         const int64_t* sel, float* out, float* buf,
                                         long long nrows, int dim, int n, int k, double norm,
                                         double scale, void* stream) {
  return launch_srht_t_large<float>(y, signs, sel, out, buf, nrows, dim, n, k, norm, scale,
                                    stream);
}

cudaError_t repro_srht_apply_t_large_f64(const double* y, const double* signs,
                                         const int64_t* sel, double* out, double* buf,
                                         long long nrows, int dim, int n, int k, double norm,
                                         double scale, void* stream) {
  return launch_srht_t_large<double>(y, signs, sel, out, buf, nrows, dim, n, k, norm, scale,
                                     stream);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The entry points as functions of the extension module repro_srht
// (pymodule.cuh): the transpose's main-path calls are a few rows, where
// the host's launch path is the whole time.
// ---------------------------------------------------------------------------

namespace {

PyMethodDef kMethods[] = {
    REPRO_METHOD(repro_fwht_f32),
    REPRO_METHOD(repro_fwht_f64),
    REPRO_METHOD(repro_srht_apply_f32),
    REPRO_METHOD(repro_srht_apply_f64),
    REPRO_METHOD(repro_srht_apply_t_f32),
    REPRO_METHOD(repro_srht_apply_t_f64),
    REPRO_METHOD(repro_srht_apply_large_f32),
    REPRO_METHOD(repro_srht_apply_large_f64),
    REPRO_METHOD(repro_srht_apply_t_large_f32),
    REPRO_METHOD(repro_srht_apply_t_large_f64),
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "repro_srht", nullptr, -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_repro_srht(void) { return PyModule_Create(&kModule); }
