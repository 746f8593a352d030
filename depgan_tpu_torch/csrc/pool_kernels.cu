// The two 2x2 max-pools of the training path for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas kernels of depgan_tpu/ops/conv_s2d_pallas.py:
//  - pool_s2d_pallas (:198, kernel _pool_kernel :175): a padded s2d plane
//    (batch, n+2, n+2, 4C) -> the pixel-domain pool (batch, n, n, C). A pool
//    window is the four sub-pixel groups of one s2d position, so each output
//    vector is the max of four input vectors at the same position.
//  - pool_to_s2d_pallas (:283, kernel _pool_to_s2d_kernel :253): the same
//    pool written straight into the next level's padded s2d plane
//    (batch, n/2+2, n/2+2, 4C) with its zero ring:
//      out[b, i, j, (2p+q)C + c] = max_g x[b, 2i-1+p, 2j-1+q, gC + c]
//    for interior (i, j) in [1, n/2]^2.
// On the path: the generator's level-1 (n = 128, 4C = 128) and level-2
// (n = 64, 4C = 256) pools, and the critic's level-0 (n = 128, 4C = 64) and
// level-1 (n = 64, 4C = 128) pools.
//
// Pure data movement: each thread owns one 16-byte vector of the output,
// reads the four 16-byte input vectors it needs and writes one, so the
// bound is the bytes of the input interior read once plus the output
// written once (PERF.md). The Pallas version held a whole plane in VMEM;
// here nothing is staged. Max is taken in f32, which is exact for bf16.
// C must be a multiple of 8 elements (whole vectors) and the planes 16-byte
// aligned; the wrappers check both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte vector

template <typename T>
union Pack {
  uint4 u;
  T v[kVec<T>];
};

// The max over the four sub-pixel groups of the vector at src.
template <typename T>
__device__ __forceinline__ uint4 group_max(const T* src, int c) {
  constexpr int VEC = kVec<T>;
  Pack<T> m, t;
  m.u = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int g = 1; g < 4; ++g) {
    t.u = *reinterpret_cast<const uint4*>(src + g * c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) m.v[j] = from_f32<T>(fmaxf(to_f32(m.v[j]), to_f32(t.v[j])));
  }
  return m.u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pool_s2d(const T* __restrict__ x, T* __restrict__ out,
                                                     int batch, int n, int c) {
  constexpr int VEC = kVec<T>;
  const int cv = c / VEC, side = n + 2;
  const int64_t total = (int64_t)batch * n * n * cv;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int v = (int)(e % cv);
    const int64_t pos = e / cv;  // (b, y, x) of the output
    const int xx = (int)(pos % n), y = (int)(pos / n % n), b = (int)(pos / ((int64_t)n * n));
    const T* src = x + (((int64_t)b * side + y + 1) * side + xx + 1) * 4 * c + v * VEC;
    *reinterpret_cast<uint4*>(out + pos * c + v * VEC) = group_max(src, c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pool_to_s2d(const T* __restrict__ x,
                                                        T* __restrict__ out, int batch, int n,
                                                        int c) {
  constexpr int VEC = kVec<T>;
  const int c4 = 4 * c, cv = c4 / VEC, side = n + 2, half = n / 2, oside = half + 2;
  const int64_t total = (int64_t)batch * oside * oside * cv;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int ch = (int)(e % cv) * VEC;
    const int64_t pos = e / cv;  // (b, i, j) of the output plane
    const int j = (int)(pos % oside), i = (int)(pos / oside % oside);
    const int b = (int)(pos / ((int64_t)oside * oside));
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i >= 1 && i <= half && j >= 1 && j <= half) {
      const int grp = ch / c, cc = ch % c, p = grp >> 1, q = grp & 1;
      const T* src = x + (((int64_t)b * side + 2 * i - 1 + p) * side + 2 * j - 1 + q) * c4 + cc;
      val = group_max(src, c);
    }
    *reinterpret_cast<uint4*>(out + pos * c4 + ch) = val;
  }
}

template <typename T>
int launch_pool(bool to_s2d, const void* x, void* out, int batch, int n, int c4,
                cudaStream_t stream) {
  constexpr int VEC = kVec<T>;
  const int c = c4 / 4;
  if (batch <= 0 || n <= 0 || c4 % 4 != 0 || c % 8 != 0 || (to_s2d && n % 2 != 0))
    return cudaErrorInvalidValue;
  const int64_t total = to_s2d ? (int64_t)batch * (n / 2 + 2) * (n / 2 + 2) * c4 / VEC
                               : (int64_t)batch * n * n * c / VEC;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads < (1 << 20)
                                       ? (total + kThreads - 1) / kThreads
                                       : (1 << 20));
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (to_s2d) {
    pool_to_s2d<T><<<grid, kThreads, 0, stream>>>(xi, o, batch, n, c);
  } else {
    pool_s2d<T><<<grid, kThreads, 0, stream>>>(xi, o, batch, n, c);
  }
  return cudaGetLastError();
}

int dispatch(int dtype, bool to_s2d, const void* x, void* out, int batch, int n, int c4,
             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pool<float>(to_s2d, x, out, batch, n, c4, s);
  if (dtype == 1) return launch_pool<__nv_bfloat16>(to_s2d, x, out, batch, n, c4, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (batch, n+2, n+2, c4) padded s2d. out: (batch, n, n, c4/4).
extern "C" int depgan_pool_s2d(int dtype, const void* x, void* out, int batch, int n, int c4,
                               void* stream) {
  return dispatch(dtype, false, x, out, batch, n, c4, stream);
}

// x: (batch, n+2, n+2, c4) padded s2d. out: (batch, n/2+2, n/2+2, c4).
extern "C" int depgan_pool_to_s2d(int dtype, const void* x, void* out, int batch, int n, int c4,
                                  void* stream) {
  return dispatch(dtype, true, x, out, batch, n, c4, stream);
}
