// Walsh-Hadamard transform and the fused SRHT (forward and transpose)
// for NVIDIA Hopper (sm_90a), in float and double.
//
// Replaces the Pallas TPU kernels
//   fwht_pallas          (src/repro/kernels/fwht.py:51, body _fwht_kernel)
//   srht_apply_pallas    (src/repro/kernels/srht.py:98, body _srht_fwd_kernel)
//   srht_apply_t_pallas  (src/repro/kernels/srht.py:130, body _srht_t_kernel)
// The TPU bodies factor H_n into two small dense matmuls for the MXU and
// compute in float32. Here the three share one shared-memory butterfly
// (`butterfly` below) and compute in the input type, so a double input
// stays double on Hopper's FP64 units.
//
// What bounds them: bytes. Per row the transform does n*log2(n) adds on
// n values, about one operation per byte moved, far below the card's
// ratio of peak FP64 rate to memory rate. On the main path (n = 32,
// millions of rows) the least time is the rows read plus the rows
// written over 3.35 TB/s.
//
// What the design does about it: each row crosses device memory once.
// A block loads R rows into shared memory (padding and sign flip applied
// on load, reads coalesced along the contiguous row-major input), runs
// all log2(n) stages there, and writes only what the caller keeps: the k
// sampled entries forward, the first dim entries for the transpose. R is
// chosen so that a block holds about 4096 values. The forward transform
// of narrow rows (n <= 32; the main path's n = 32) skips shared memory:
// a warp holds 32/n rows, one value per lane, runs the stages as
// register shuffles and gathers the k kept entries by a shuffle, with
// several rows in flight per lane so that enough loads are outstanding.
//
// A row longer than kMaxN = 2^14 does not fit in a block's shared
// memory. It is transformed in passes that keep the stage order: first
// the low stages (h < 2^14) on contiguous chunks of 2^14 in shared
// memory, then the high stages along the strided axis of the row viewed
// as (n / 2^14, 2^14), up to 2^14 stages' worth of that axis a pass (one
// pass for n <= 2^28), each block holding a tile of whole columns so the
// loads stay coalesced. The SRHT forms fold the padding and sign flip
// into the first pass's load (forward) or the scaled scatter into it
// (transpose), and finish with a gather (forward) or a sign flip and
// truncation (transpose) over the transformed rows in a scratch buffer
// the wrapper allocates.
//
// Op order follows repro.kernels.ref exactly (stages h = 1, 2, 4, ...;
// pairs (a + b, a - b); x 1/sqrt(n); then x sqrt(n/k) after the gather,
// or x sqrt(n/k) before the scatter for the transpose), and the scale
// factors come from the host already rounded to the input type. Built
// with -fmad=false, so no multiply is contracted into a later add: the
// results are bit-equal to the plain PyTorch version.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockValues = 4096;  // values of T a block holds (rows * n)
constexpr int kLogMaxN = 14;
constexpr int kMaxN = 1 << kLogMaxN;  // n * 8 bytes = 128 KB of shared memory; SINGLE_PASS_N in fwht.py
constexpr int kLogTileValues = 12;    // values of a strided pass's tile (at least one column)
constexpr int kWarpN = 32;          // largest n of the register (warp) forward path
constexpr int kWarpUnroll = 4;      // row groups a warp holds at once

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

template <typename T>
__global__ void fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
                            long long nrows, int log_n, int rpb, T norm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << log_n;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int rows = (int)min((long long)rpb, nrows - r0);
  const int count = rows * n;
  const T* src = x + r0 * n;
  for (int e = threadIdx.x; e < count; e += blockDim.x) buf[e] = src[e];
  butterfly(buf, rows, log_n);
  T* dst = out + r0 * n;
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = buf[e] * norm;
}

template <typename T>
__global__ void srht_fwd_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                                const int64_t* __restrict__ sel, T* __restrict__ out,
                                long long nrows, int dim, int log_n, int k, int rpb,
                                T norm, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int n = 1 << log_n;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int rows = (int)min((long long)rpb, nrows - r0);
  // zero-pad to n, then flip signs: padding becomes 0 * sign, as in the
  // reference's pad-then-multiply
  const int count = rows * n;
  const T* src = x + r0 * dim;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e >> log_n;
    const int j = e & (n - 1);
    const T v = j < dim ? src[(long long)r * dim + j] : T(0);
    buf[e] = v * signs[j];
  }
  butterfly(buf, rows, log_n);
  T* dst = out + r0 * k;
  const int outs = rows * k;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int r = e / k;
    const int c = e - r * k;
    const T h = buf[(r << log_n) + (int)sel[c]] * norm;
    dst[e] = h * scale;
  }
}

// Forward SRHT for n <= 32 in registers: lane l holds coordinate
// j = l % n of row slot l / n; stage h pairs lanes l and l ^ h, the lower
// one (bit h clear) keeping a + b and the upper one a - b, exactly the
// shared-memory butterfly's arithmetic.
template <typename T>
__global__ void srht_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                                     const int64_t* __restrict__ sel, T* __restrict__ out,
                                     long long nrows, int dim, int log_n, int k, T norm,
                                     T scale) {
  const int n = 1 << log_n;
  const int lane = threadIdx.x & 31;
  const int j = lane & (n - 1);
  const int slot = lane >> log_n;
  const int per_warp = 32 >> log_n;
  const T sign = signs[j];
  // the lane whose value output entry j of this lane's row takes
  const int src = (lane & ~(n - 1)) + (j < k ? (int)sel[j] : 0);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long row0 = warp * per_warp * kWarpUnroll + slot;
  T v[kWarpUnroll];
#pragma unroll
  for (int u = 0; u < kWarpUnroll; ++u) {
    const long long row = row0 + (long long)u * per_warp;
    const T val = (j < dim && row < nrows) ? x[row * dim + j] : T(0);
    v[u] = val * sign;
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
    const T g = __shfl_sync(0xffffffffu, v[u], src) * norm;
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
// Rows longer than kMaxN: the low stages on contiguous chunks of kMaxN, then
// the high stages along the strided axis.
// ---------------------------------------------------------------------------

// First pass of a long forward SRHT row: block b holds chunk b % chunks of
// row b / chunks, padded and sign-flipped on load, runs the low stages and
// writes the chunk whole.
template <typename T>
__global__ void srht_fwd_low_kernel(const T* __restrict__ x, const T* __restrict__ signs,
                                    T* __restrict__ buf, int dim, int log_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int log_chunks = log_n - kLogMaxN;
  const long long r = (long long)blockIdx.x >> log_chunks;
  const long long j0 = ((long long)blockIdx.x & ((1LL << log_chunks) - 1)) << kLogMaxN;
  const T* src = x + r * dim;
  for (int e = threadIdx.x; e < kMaxN; e += blockDim.x) {
    const long long j = j0 + e;
    const T v = j < dim ? src[j] : T(0);
    s[e] = v * signs[j];
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

// Stages h = lo, 2 lo, ..., lo * 2^(log_r - 1), in place: buf viewed as
// (groups, 2^log_r, lo), a block holding 2^log_cols consecutive columns of
// one group (rows of the tile are contiguous runs, so loads coalesce).
// The results are scaled by norm as they are written (1 but on the last
// pass of a normalized transform).
template <typename T>
__global__ void fwht_strided_kernel(T* buf, int log_r, long long lo, int log_cols, T norm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int cols = 1 << log_cols;
  const int count = 1 << (log_r + log_cols);
  const long long tiles = lo >> log_cols;
  const long long g = (long long)blockIdx.x / tiles;
  const long long c0 = ((long long)blockIdx.x - g * tiles) << log_cols;
  T* base = buf + g * (lo << log_r) + c0;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    s[e] = base[(long long)(e >> log_cols) * lo + (e & (cols - 1))];
  }
  const int pairs = count >> 1;
  for (int log_h = 0; log_h < log_r; ++log_h) {
    const int h = 1 << log_h;
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int c = p & (cols - 1);
      const int q = p >> log_cols;
      const int a = ((((q >> log_h) << (log_h + 1)) + (q & (h - 1))) << log_cols) + c;
      const int b = a + (h << log_cols);
      const T va = s[a];
      const T vb = s[b];
      s[a] = va + vb;
      s[b] = va - vb;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    base[(long long)(e >> log_cols) * lo + (e & (cols - 1))] = s[e] * norm;
  }
}

template <typename T>
__global__ void srht_gather_kernel(const T* __restrict__ buf, const int64_t* __restrict__ sel,
                                   T* __restrict__ out, long long nrows, int log_n, int k,
                                   T norm, T scale) {
  const long long total = nrows * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / k;
    const int c = (int)(e - r * k);
    const T h = buf[(r << log_n) + sel[c]] * norm;
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

// Launch geometry shared by the three kernels: grid, rows per block and
// dynamic shared memory, with the opt-in above 48 KB.
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

// The high stages (h >= kMaxN) of nrows rows of length 2^log_n held in buf,
// in place, in passes of at most kMaxN along the strided axis; the last
// pass scales by norm.
template <typename T>
cudaError_t high_stages(T* buf, long long nrows, int log_n, T norm, cudaStream_t stream) {
  for (int log_lo = kLogMaxN; log_lo < log_n;) {
    const int log_r = std::min(log_n - log_lo, kLogMaxN);
    const int log_cols = std::max(0, kLogTileValues - log_r);
    const long long blocks = (nrows << (log_n - log_lo - log_r)) << (log_lo - log_cols);
    const size_t smem = ((size_t)1 << (log_r + log_cols)) * sizeof(T);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(fwht_strided_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const bool last = log_lo + log_r == log_n;
    fwht_strided_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
        buf, log_r, 1LL << log_lo, log_cols, last ? norm : T(1));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    log_lo += log_r;
  }
  return cudaSuccess;
}

inline unsigned elementwise_blocks(long long total) {
  return (unsigned)std::max(1LL, std::min((total + kThreads - 1) / kThreads, 1LL << 20));
}

template <typename T>
cudaError_t launch_fwht(const T* x, T* out, long long nrows, int n, double norm,
                        void* stream) {
  if (long_row(nrows, n)) {
    // low stages: x -> out in chunks of kMaxN, one chunk a block (the
    // single-pass kernel at n = kMaxN, unscaled); then the high stages
    const long long chunks = nrows << (log2_int(n) - kLogMaxN);
    int rpb;
    unsigned blocks;
    size_t smem;
    cudaError_t err = configure(fwht_kernel<T>, chunks, kMaxN, sizeof(T), &rpb, &blocks, &smem);
    if (err != cudaSuccess) return err;
    fwht_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        x, out, chunks, kLogMaxN, rpb, T(1));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return high_stages(out, nrows, log2_int(n), (T)norm, (cudaStream_t)stream);
  }
  int rpb;
  unsigned blocks;
  size_t smem;
  cudaError_t err = configure(fwht_kernel<T>, nrows, n, sizeof(T), &rpb, &blocks, &smem);
  if (err != cudaSuccess) return err;
  fwht_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, nrows, log2_int(n), rpb, (T)norm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_srht(const T* x, const T* signs, const int64_t* sel, T* out,
                        long long nrows, int dim, int n, int k, double norm,
                        double scale, void* stream) {
  if (n >= 1 && n <= kWarpN && (n & (n - 1)) == 0 && nrows > 0) {
    const long long rows_per_block = (long long)(kThreads / 32) * (32 / n) * kWarpUnroll;
    const unsigned blocks = (unsigned)((nrows + rows_per_block - 1) / rows_per_block);
    srht_fwd_warp_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, signs, sel, out, nrows, dim, log2_int(n), k, (T)norm, (T)scale);
    return cudaGetLastError();
  }
  int rpb;
  unsigned blocks;
  size_t smem;
  cudaError_t err = configure(srht_fwd_kernel<T>, nrows, n, sizeof(T), &rpb, &blocks, &smem);
  if (err != cudaSuccess) return err;
  srht_fwd_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, signs, sel, out, nrows, dim, log2_int(n), k, rpb, (T)norm, (T)scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_srht_t(const T* y, const T* signs, const int64_t* sel, T* out,
                          long long nrows, int dim, int n, int k, double norm,
                          double scale, void* stream) {
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
// (nrows, n): padded, sign-flipped low stages; high stages; gather.
template <typename T>
cudaError_t launch_srht_large(const T* x, const T* signs, const int64_t* sel, T* out, T* buf,
                              long long nrows, int dim, int n, int k, double norm,
                              double scale, void* stream) {
  if (!long_row(nrows, n)) return cudaErrorInvalidValue;
  const int log_n = log2_int(n);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)kMaxN * sizeof(T);
  cudaError_t err = allow_smem(srht_fwd_low_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  srht_fwd_low_kernel<T><<<(unsigned)(nrows << (log_n - kLogMaxN)), kThreads, smem, s>>>(
      x, signs, buf, dim, log_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = high_stages(buf, nrows, log_n, T(1), s);
  if (err != cudaSuccess) return err;
  srht_gather_kernel<T><<<elementwise_blocks(nrows * k), kThreads, 0, s>>>(
      buf, sel, out, nrows, log_n, k, (T)norm, (T)scale);
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
  err = high_stages(buf, nrows, log_n, T(1), s);
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

cudaError_t repro_srht_apply_f32(const float* x, const float* signs, const int64_t* sel,
                                 float* out, long long nrows, int dim, int n, int k,
                                 double norm, double scale, void* stream) {
  return launch_srht<float>(x, signs, sel, out, nrows, dim, n, k, norm, scale, stream);
}

cudaError_t repro_srht_apply_f64(const double* x, const double* signs, const int64_t* sel,
                                 double* out, long long nrows, int dim, int n, int k,
                                 double norm, double scale, void* stream) {
  return launch_srht<double>(x, signs, sel, out, nrows, dim, n, k, norm, scale, stream);
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
                                       float* out, float* buf, long long nrows, int dim, int n,
                                       int k, double norm, double scale, void* stream) {
  return launch_srht_large<float>(x, signs, sel, out, buf, nrows, dim, n, k, norm, scale,
                                  stream);
}

cudaError_t repro_srht_apply_large_f64(const double* x, const double* signs,
                                       const int64_t* sel, double* out, double* buf,
                                       long long nrows, int dim, int n, int k, double norm,
                                       double scale, void* stream) {
  return launch_srht_large<double>(x, signs, sel, out, buf, nrows, dim, n, k, norm, scale,
                                   stream);
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
