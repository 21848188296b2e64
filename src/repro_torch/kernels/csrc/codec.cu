// The transport codecs' inner loops for NVIDIA Hopper (sm_90a), in float
// and double: the magnitude top-k mask and the int8 quantize-dequantize
// round trip, one payload (one client) per row of a (rows, P) tensor.
//
// Replaces the Pallas TPU kernels
//   topk_mask_pallas        (src/repro/kernels/codec_kernels.py:85, body _topk_kernel)
//   qint8_roundtrip_pallas  (src/repro/kernels/codec_kernels.py:112, body _qint8_kernel)
// The TPU bodies cast to float32 and run one payload per call (vmapped
// over clients); here one launch takes every client's payload and
// computes in the input type. A float32 cast of float64 magnitudes would
// merge distinct values into ties and change which entries top-k keeps.
//
// What bounds them: bytes, by a wide margin. Each reads its row (and the
// noise) and writes one row; the arithmetic is a few operations per
// value. On the main path the rows are short (P = 10 to 100, rows = 1000
// clients or 1 broadcast): the bytes take well under a microsecond, so
// what a block does one step after another, and the host's launch path,
// are the time.
//
// What the design does about it: rows of P <= kWarpMaxP take one warp
// each, several rows a block, with no shared memory and no block barrier;
// each lane holds values i = 32 r + lane in register r, so loads are
// coalesced and (register, lane) order is index order. Longer rows take a
// block each. The library is also the Python extension module repro_codec
// (pymodule.cuh), whose functions launch with less host time than ctypes.
//
//   topk_mask_warp_kernel: the threshold is the kept-th largest bit
//   pattern of |x| (non-negative IEEE values order like their unsigned
//   patterns), found MSB first. The leading bits every value shares are
//   skipped (a warp AND and OR of the patterns); for each bit left, the
//   candidates with the bit set are counted (__reduce_add_sync), and the
//   search stops once the candidates left are as many as the values still
//   needed. A bit that every candidate shares starts another skip, of the
//   bits the candidates share, which ends the search where they are all
//   equal: a row of ties takes a few steps, not one a bit. Values above the threshold are kept, and of the candidates the
//   first `need` in index order: a candidate's rank is the candidates in
//   earlier registers plus __popc(ballot & lanes below). Ties go to the
//   lowest index, as jax.lax.top_k and the plain version's stable sort
//   decide.
//
//   topk_mask_kernel (P > kWarpMaxP): radix selection one byte a pass from
//   the top (4 passes for float, 8 for double), each a block-wide 256-bin
//   histogram of the candidates; warp 0 finds the threshold's bin by a
//   suffix sum over the bins with shuffles and a ballot. The row's
//   patterns are cached in shared memory up to kCacheBytes and streamed
//   from device memory (the L2 cache serves the repeats) beyond, so no
//   length limit exists. Ties are ranked by a block-wide prefix count.
//
//   Both copy the kept entries and write 0 elsewhere: no arithmetic, so
//   the result is bit-equal to the plain version; ±0, inf, subnormals and
//   NaN order by their patterns.
//
//   qint8: max |x| of the row (exact: a max does not depend on order; NaN
//   propagates as in torch.amax), then scale = max(max|x| / 127, tiny),
//   q = clip(floor(x / scale + u), -127, 127), out = q * scale, in that
//   order. Built with -fmad=false and without fast math, so the division,
//   the add and the multiply round as the plain PyTorch version's do.
//   qint8_warp_kernel holds x and u in registers and takes the max by
//   shuffles; qint8_kernel (P > kWarpMaxP) takes a block a row, 16-byte
//   loads where the rows are 16-byte aligned.
//
// Every entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pymodule.cuh"

namespace {

constexpr int kThreads = 256;  // block routes
constexpr int kWarps = kThreads / 32;
constexpr int kCacheBytes = 32 * 1024;  // a row's bit patterns cached up to this size
constexpr int kRowWarps = 4;            // warp routes: rows (one a warp) per block
constexpr int kWarpMaxP = 1024;         // warp routes: the longest row (32 values a lane)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Bits;

template <>
struct Bits<float> {
  using U = uint32_t;
  static constexpr U kAbs = 0x7fffffffu;
  __device__ static U raw(float v) { return __float_as_uint(v); }
  __device__ static float from(U b) { return __uint_as_float(b); }
  __device__ static U of(float v) { return raw(v) & kAbs; }
  __device__ static U warp_and(U v) { return __reduce_and_sync(kFull, v); }
  __device__ static U warp_or(U v) { return __reduce_or_sync(kFull, v); }
  __device__ static int msb(U v) { return 31 - __clz(v); }
};

template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr U kAbs = 0x7fffffffffffffffull;
  __device__ static U raw(double v) { return (U)__double_as_longlong(v); }
  __device__ static double from(U b) { return __longlong_as_double((long long)b); }
  __device__ static U of(double v) { return raw(v) & kAbs; }
  __device__ static U warp_and(U v) {
    return ((U)__reduce_and_sync(kFull, (unsigned)(v >> 32)) << 32) |
           __reduce_and_sync(kFull, (unsigned)v);
  }
  __device__ static U warp_or(U v) {
    return ((U)__reduce_or_sync(kFull, (unsigned)(v >> 32)) << 32) |
           __reduce_or_sync(kFull, (unsigned)v);
  }
  __device__ static int msb(U v) { return 63 - __clzll((long long)v); }
};

// ---------------------------------------------------------------------------
// topk_mask, rows of P <= kWarpMaxP: a warp a row, R values a lane
// ---------------------------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kRowWarps * 32)
topk_mask_warp_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows, int P,
                      int kept) {
  using B = Bits<T>;
  using U = typename B::U;
  constexpr U kSign = ~B::kAbs;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* src = x + row * P;
  T* dst = out + row * P;

  // v[r]: |x| of value 32 r + lane as a pattern; past the row's end the
  // sign bit, which no threshold has, so those slots are never candidates
  U v[R];
  unsigned neg = 0;  // bit r: value 32 r + lane is negative
  U all_and = ~U(0), all_or = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    v[r] = kSign;
    if (i < P) {
      const U b = B::raw(src[i]);
      v[r] = b & B::kAbs;
      neg |= (unsigned)(b >> (8 * sizeof(U) - 1)) << r;
      all_and &= v[r];
      all_or |= v[r];
    }
  }

  // the threshold's bits in `fixed` are `prefix`; `cands` values share
  // them and `need` of those are still to be kept; values whose fixed bits
  // exceed `prefix` are kept
  all_and = B::warp_and(all_and);
  all_or = B::warp_or(all_or);
  const U diff = all_and ^ all_or;  // bits that differ somewhere in the row
  U fixed = ~U(0);
  U prefix = all_and;
  int need = kept;
  int cands = P;
  if (diff != 0) {
    const int top = B::msb(diff);  // below the sign bit: |x| has none
    fixed = ~((U(2) << top) - 1);
    prefix = all_and & fixed;
    for (int b = top; b >= 0 && cands != need; --b) {
      const U bit = U(1) << b;
      int c = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) c += ((v[r] & fixed) == prefix) & ((v[r] & bit) != 0);
      c = (int)__reduce_add_sync(kFull, (unsigned)c);
      if (c == 0 || c == cands) {
        // the candidates share this bit, and maybe the next ones: skip to
        // the highest bit at which they differ, or stop where they are all
        // equal (ties) and the threshold is their value
        U c_and = ~U(0), c_or = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((v[r] & fixed) == prefix) {
            c_and &= v[r];
            c_or |= v[r];
          }
        }
        c_and = B::warp_and(c_and);
        c_or = B::warp_or(c_or);
        const U d = c_and ^ c_or;
        if (d == 0) {
          prefix = c_and;
          fixed = ~U(0);
          break;
        }
        b = B::msb(d);  // below bit b, which the candidates share
        fixed = ~((U(2) << b) - 1);
        prefix = c_and & fixed;
        ++b;  // the loop's --b takes bit b next
        continue;
      }
      if (c >= need) {
        prefix |= bit;
        cands = c;
      } else {
        need -= c;
        cands -= c;
      }
      fixed |= bit;
    }
  }

  // keep the values above and the first `need` candidates in index order
  const unsigned below = (1u << lane) - 1u;
  int ties = 0;  // candidates in earlier registers
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const U m = v[r] & fixed;
    const bool at = m == prefix;
    const unsigned ballot = __ballot_sync(kFull, at);
    const bool keep = m > prefix || (at && ties + __popc(ballot & below) < need);
    ties += __popc(ballot);
    const int i = 32 * r + lane;
    if (i < P) {
      dst[i] = keep ? B::from(v[r] | ((U)((neg >> r) & 1u) << (8 * sizeof(U) - 1))) : T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// topk_mask, rows of P > kWarpMaxP: a block a row, a byte a pass
// ---------------------------------------------------------------------------

// 8 blocks an SM (32 registers a thread): 1000 rows, one a block, fit the
// card's 132 SMs in one wave
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
topk_mask_kernel(const T* __restrict__ x, T* __restrict__ out, long long P, long long kept,
                 int cached) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* cache = reinterpret_cast<U*>(smem_raw);
  __shared__ __align__(16) unsigned hist[256];
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
    if (warp == 0) {
      // the threshold's byte is the highest bin b whose suffix sum (the
      // candidates in bins >= b) reaches `need`; lane l holds bins 8l..8l+7
      const uint4 lo = reinterpret_cast<const uint4*>(hist)[2 * lane];
      const uint4 hi = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
      const unsigned local = lo.x + lo.y + lo.z + lo.w + hi.x + hi.y + hi.z + hi.w;
      unsigned suffix = local;  // the candidates in bins >= 8 lane
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_down_sync(kFull, suffix, d);
        if (lane + d < 32) suffix += o;
      }
      // lane 0's suffix is every candidate, so some lane reaches `need`
      const unsigned reach = __ballot_sync(kFull, (long long)suffix >= need);
      if (lane == 31 - __clz(reach)) {
        // the lane's bins read again (volatile), not kept in registers
        // across the scan: the kernel has 32 registers a thread
        const volatile unsigned* bins = hist + 8 * lane;
        unsigned h[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) h[t] = bins[t];
        long long above = (long long)(suffix - local);  // in bins >= 8 (lane + 1)
        int j = 7;
#pragma unroll
        for (int t = 7; t > 0; --t) {
          if (j == t && above + h[t] < need) {
            above += h[t];
            j = t - 1;
          }
        }
        s_need = need - above;
        s_prefix = prefix | ((U)(8 * lane + j) << shift);
      }
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

// ---------------------------------------------------------------------------
// qint8_roundtrip
// ---------------------------------------------------------------------------

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
__device__ T qint8_scale(T amax, T tiny) {
  const T scale = amax / T(127);
  return scale < tiny ? tiny : scale;  // NaN stays NaN
}

template <typename T>
__device__ T qint8_value(T x, T u, T scale) {
  T q = floor_t(x / scale + u);
  q = q < T(-127) ? T(-127) : (q > T(127) ? T(127) : q);
  return q * scale;
}

// rows of P <= kWarpMaxP: a warp a row, x and u read once into registers
template <typename T, int R>
__global__ void __launch_bounds__(kRowWarps * 32)
qint8_warp_kernel(const T* __restrict__ x, const T* __restrict__ u, T* __restrict__ out,
                  long long rows, int P, T tiny) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long off = row * P;
  T xv[R], uv[R];
  T m = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    xv[r] = T(0);
    uv[r] = T(0);
    if (i < P) {
      xv[r] = x[off + i];
      uv[r] = u[off + i];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) m = max_nan(m, abs_t(xv[r]));
  for (int d = 16; d > 0; d >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, d));
  const T scale = qint8_scale(m, tiny);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    if (i < P) out[off + i] = qint8_value(xv[r], uv[r], scale);
  }
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  static constexpr int kN = 4;
};
template <>
struct Vec16<double> {
  using V = double2;
  static constexpr int kN = 2;
};

__device__ inline float vec_max_abs(float m, const float4& v) {
  return max_nan(max_nan(m, abs_t(v.x)), max_nan(max_nan(abs_t(v.y), abs_t(v.z)), abs_t(v.w)));
}
__device__ inline double vec_max_abs(double m, const double2& v) {
  return max_nan(max_nan(m, abs_t(v.x)), abs_t(v.y));
}
__device__ inline float4 vec_q(const float4& x, const float4& u, float s) {
  return make_float4(qint8_value(x.x, u.x, s), qint8_value(x.y, u.y, s),
                     qint8_value(x.z, u.z, s), qint8_value(x.w, u.w, s));
}
__device__ inline double2 vec_q(const double2& x, const double2& u, double s) {
  return make_double2(qint8_value(x.x, u.x, s), qint8_value(x.y, u.y, s));
}

// rows of P > kWarpMaxP: a block a row; with VEC, 16-byte loads and stores
// (the rows start on 16-byte boundaries), else one value at a time
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
qint8_kernel(const T* __restrict__ x, const T* __restrict__ u, T* __restrict__ out,
             long long P, T tiny) {
  using V = typename Vec16<T>::V;
  constexpr int kN = Vec16<T>::kN;
  __shared__ T warp_max[kWarps];
  const int tid = threadIdx.x;
  const long long off = (long long)blockIdx.x * P;
  T m = T(0);
  if constexpr (VEC) {
    const V* xv = reinterpret_cast<const V*>(x + off);
#pragma unroll 4
    for (long long i = tid; i < P / kN; i += kThreads) m = vec_max_abs(m, xv[i]);
  } else {
    for (long long i = tid; i < P; i += kThreads) m = max_nan(m, abs_t(x[off + i]));
  }
  for (int d = 16; d > 0; d >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, d));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  T amax = warp_max[0];
  for (int w = 1; w < kWarps; ++w) amax = max_nan(amax, warp_max[w]);
  const T scale = qint8_scale(amax, tiny);
  if constexpr (VEC) {
    const V* xv = reinterpret_cast<const V*>(x + off);
    const V* uv = reinterpret_cast<const V*>(u + off);
    V* ov = reinterpret_cast<V*>(out + off);
#pragma unroll 4
    for (long long i = tid; i < P / kN; i += kThreads) ov[i] = vec_q(xv[i], uv[i], scale);
  } else {
    for (long long i = tid; i < P; i += kThreads) {
      out[off + i] = qint8_value(x[off + i], u[off + i], scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// values a lane holds on the warp routes: the least power of two with
// 32 R >= P
int warp_regs(long long P) {
  int r = 1;
  while (32LL * r < P) r <<= 1;
  return r;
}

template <typename F>
void with_regs(int regs, F&& f) {
  switch (regs) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    default: f(std::integral_constant<int, 32>{}); break;
  }
}

unsigned warp_grid(long long rows) { return (unsigned)((rows + kRowWarps - 1) / kRowWarps); }

template <typename T>
cudaError_t launch_topk(const T* x, T* out, long long rows, long long P, long long kept,
                        void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || P <= 0 || kept < 1 || kept > P) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (P <= kWarpMaxP) {
    with_regs(warp_regs(P), [&](auto r) {
      topk_mask_warp_kernel<T, decltype(r)::value><<<warp_grid(rows), kRowWarps * 32, 0, s>>>(
          x, out, rows, (int)P, (int)kept);
    });
  } else {
    using U = typename Bits<T>::U;
    const size_t bytes = (size_t)P * sizeof(U);
    const int cached = bytes <= (size_t)kCacheBytes;
    topk_mask_kernel<T><<<(unsigned)rows, kThreads, cached ? bytes : 0, s>>>(x, out, P, kept,
                                                                            cached);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qint8(const T* x, const T* u, T* out, long long rows, long long P,
                         double tiny, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || P <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (P <= kWarpMaxP) {
    with_regs(warp_regs(P), [&](auto r) {
      qint8_warp_kernel<T, decltype(r)::value><<<warp_grid(rows), kRowWarps * 32, 0, s>>>(
          x, u, out, rows, (int)P, (T)tiny);
    });
  } else if ((P * sizeof(T)) % 16 == 0 &&
             (((uintptr_t)x | (uintptr_t)u | (uintptr_t)out) & 15) == 0) {
    qint8_kernel<T, true><<<(unsigned)rows, kThreads, 0, s>>>(x, u, out, P, (T)tiny);
  } else {
    qint8_kernel<T, false><<<(unsigned)rows, kThreads, 0, s>>>(x, u, out, P, (T)tiny);
  }
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

// ---------------------------------------------------------------------------
// The entry points as functions of the extension module repro_codec
// (pymodule.cuh): every codec call on the main path is one small launch,
// where the host's launch path is most of the time.
// ---------------------------------------------------------------------------

namespace {

PyMethodDef kMethods[] = {
    REPRO_METHOD(repro_topk_mask_f32),
    REPRO_METHOD(repro_topk_mask_f64),
    REPRO_METHOD(repro_qint8_roundtrip_f32),
    REPRO_METHOD(repro_qint8_roundtrip_f64),
    REPRO_ERROR_STRING_METHOD,
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "repro_codec", nullptr, -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_repro_codec(void) { return PyModule_Create(&kModule); }
