// The transport codecs' inner loops for NVIDIA Hopper (sm_90a), in float
// and double: the magnitude top-k mask and the int8 quantize-dequantize
// round trip, one payload (one client) per row of a (rows, P) tensor.
//
// Replaces the Pallas TPU kernels
//   topk_mask_pallas        (src/repro/kernels/codec_kernels.py:85, body _topk_kernel)
//   qint8_roundtrip_pallas  (src/repro/kernels/codec_kernels.py:112, body _qint8_kernel)
// The TPU bodies cast to float32 and run one payload per call (vmapped
// over clients); here one launch takes every client's payload, one block
// per row, and computes in the input type. A float32 cast of float64
// magnitudes would merge distinct values into ties and change which
// entries top-k keeps.
//
// What bounds them: bytes. Each reads its row (and the noise) and writes
// one row; the arithmetic is a few operations per value. On the main path
// the rows are short (P = 10 to 100, rows = 1000 clients or 1 broadcast),
// so the bytes are well under a megabyte and the time is the launch's.
//
// What the design does about it: one launch per payload, whatever the
// number of clients, and no allocation. A short row lives in shared
// memory for its passes; a row too long for it is streamed from device
// memory on every pass (the L2 cache serves the repeats), so no length
// limit exists.
//
//   topk_mask: the exact kept-th largest |x| is found by radix selection
//   on the bit pattern of |x| (non-negative IEEE values order like their
//   unsigned patterns), one byte a pass from the top: 4 passes for float,
//   8 for double, each a block-wide 256-bin histogram of the candidates
//   that share the bytes fixed so far. Values above the threshold are
//   kept, and the first (kept - count above) values equal to it, in index
//   order, by a block-wide prefix count: the lowest index wins a tie, as
//   jax.lax.top_k decides. Kept entries are copied, the rest written 0.
//
//   qint8_roundtrip: a block-wide max of |x| (exact: a max does not
//   depend on order), then scale = max(max|x| / 127, tiny), q =
//   clip(floor(x / scale + u), -127, 127), out = q * scale. Built with
//   -fmad=false and without fast math, so the division, the add and the
//   multiply round as the plain PyTorch version's do; NaN propagates
//   through the max and the clip as it does there.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCacheBytes = 32 * 1024;  // a row's bit patterns cached up to this size
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Bits;

template <>
struct Bits<float> {
  using U = uint32_t;
  static constexpr U kAbs = 0x7fffffffu;
  __device__ static U of(float v) { return __float_as_uint(v) & kAbs; }
};

template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kAbs = 0x7fffffffffffffffull;
  __device__ static U of(double v) {
    return (unsigned long long)__double_as_longlong(v) & kAbs;
  }
};

template <typename T>
__global__ void topk_mask_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 long long P, long long kept, int cached) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* cache = reinterpret_cast<U*>(smem_raw);
  __shared__ unsigned hist[256];
  __shared__ U s_prefix;
  __shared__ long long s_need;
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* row = x + (long long)blockIdx.x * P;
  T* dst = out + (long long)blockIdx.x * P;
  if (cached) {
    for (long long i = tid; i < P; i += kThreads) cache[i] = Bits<T>::of(row[i]);
  }
  __syncthreads();

  // radix selection: after the pass at `shift`, `prefix` holds the
  // threshold's bytes down to `shift`, and `need` counts how many of the
  // values that share them are still to be kept
  U prefix = 0;
  U fixed = 0;
  long long need = kept;
  for (int shift = 8 * (int)sizeof(U) - 8; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (long long i0 = 0; i0 < P; i0 += kThreads) {
      const long long i = i0 + tid;
      int bin = -1;
      if (i < P) {
        const U v = cached ? cache[i] : Bits<T>::of(row[i]);
        if ((v & fixed) == prefix) bin = (int)((v >> shift) & 0xff);
      }
      // one shared-memory atomic per distinct bin in the warp
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      long long above = 0;
      int b = 255;
      for (; b > 0; --b) {
        if (above + hist[b] >= need) break;
        above += hist[b];
      }
      s_need = need - above;
      s_prefix = prefix | ((U)b << shift);
    }
    __syncthreads();
    need = s_need;
    prefix = s_prefix;
    fixed |= (U)0xff << shift;
  }

  // keep everything above the threshold and the first `need` values
  // equal to it, in index order
  const U thr = prefix;
  long long ties_before = 0;  // threshold values in earlier tiles
  for (long long i0 = 0; i0 < P; i0 += kThreads) {
    const long long i = i0 + tid;
    const bool valid = i < P;
    const U v = valid ? (cached ? cache[i] : Bits<T>::of(row[i])) : 0;
    const bool at = valid && v == thr;
    const unsigned ballot = __ballot_sync(kFull, at);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    long long rank = ties_before + __popc(ballot & ((1u << lane) - 1u));
    long long tile_ties = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) rank += warp_count[w];
      tile_ties += warp_count[w];
    }
    if (valid) dst[i] = (v > thr || (at && rank < need)) ? row[i] : T(0);
    ties_before += tile_ties;
    __syncthreads();
  }
}

__device__ inline float abs_t(float v) { return fabsf(v); }
__device__ inline double abs_t(double v) { return fabs(v); }
__device__ inline float floor_t(float v) { return floorf(v); }
__device__ inline double floor_t(double v) { return floor(v); }

// max that propagates NaN (as torch.amax and jnp.max do; fmax drops it)
template <typename T>
__device__ T max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void qint8_kernel(const T* __restrict__ x, const T* __restrict__ u,
                             T* __restrict__ out, long long P, T tiny) {
  __shared__ T warp_max[kWarps];
  const int tid = threadIdx.x;
  const long long off = (long long)blockIdx.x * P;
  T m = T(0);
  for (long long i = tid; i < P; i += kThreads) m = max_nan(m, abs_t(x[off + i]));
  for (int d = 16; d > 0; d >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, d));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  T amax = warp_max[0];
  for (int w = 1; w < kWarps; ++w) amax = max_nan(amax, warp_max[w]);
  T scale = amax / T(127);
  scale = scale < tiny ? tiny : scale;  // NaN stays NaN
  for (long long i = tid; i < P; i += kThreads) {
    T q = floor_t(x[off + i] / scale + u[off + i]);
    q = q < T(-127) ? T(-127) : (q > T(127) ? T(127) : q);
    out[off + i] = q * scale;
  }
}

template <typename T>
cudaError_t launch_topk(const T* x, T* out, long long rows, long long P, long long kept,
                        void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || P <= 0 || kept < 1 || kept > P) {
    return cudaErrorInvalidValue;
  }
  using U = typename Bits<T>::U;
  const size_t bytes = (size_t)P * sizeof(U);
  const int cached = bytes <= (size_t)kCacheBytes;
  topk_mask_kernel<T><<<(unsigned)rows, kThreads, cached ? bytes : 0, (cudaStream_t)stream>>>(
      x, out, P, kept, cached);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qint8(const T* x, const T* u, T* out, long long rows, long long P,
                         double tiny, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || P <= 0) return cudaErrorInvalidValue;
  qint8_kernel<T><<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(x, u, out, P, (T)tiny);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

cudaError_t repro_topk_mask_f32(const float* x, float* out, long long rows, long long P,
                                long long kept, void* stream) {
  return launch_topk<float>(x, out, rows, P, kept, stream);
}

cudaError_t repro_topk_mask_f64(const double* x, double* out, long long rows, long long P,
                                long long kept, void* stream) {
  return launch_topk<double>(x, out, rows, P, kept, stream);
}

cudaError_t repro_qint8_roundtrip_f32(const float* x, const float* u, float* out,
                                      long long rows, long long P, double tiny, void* stream) {
  return launch_qint8<float>(x, u, out, rows, P, tiny, stream);
}

cudaError_t repro_qint8_roundtrip_f64(const double* x, const double* u, double* out,
                                      long long rows, long long P, double tiny, void* stream) {
  return launch_qint8<double>(x, u, out, rows, P, tiny, stream);
}

}  // extern "C"
