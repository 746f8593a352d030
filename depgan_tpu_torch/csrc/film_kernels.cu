// The FiLM residual of the generator's training path for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces the Pallas kernel of depgan_tpu/ops/film_pallas.py:
// film_residual (:58, forward _film_forward :64, kernel _film_kernel :28):
//     out[b, y, x, c] = trunk[b, y, x, c] + max(h[b, y, x, c] * gamma[b, c] + beta[b, c], 0)
// over NHWC tensors, gamma and beta (batch, C) in the dtype of h, the whole
// chain in f32 and rounded once at the store. On the path: every FiLM site
// of GenUNet2D with use_pallas (7 per forward), the UResNet trainer's and
// the batch-BN GAN generator's.
//
// Pure elementwise work: the bound is the bytes of h and trunk read once
// and out written once (gamma and beta are B*C values, cached). Each thread
// owns one 16-byte vector of the flattened tensors (4 channels in f32, 8 in
// bf16) in a grid-stride loop: two 16-byte loads, one 16-byte store. Where C
// is a multiple of the vector, gamma and beta come in as 16-byte vectors at
// (b, c); otherwise each element finds its own (b, c) and the last
// numel % vector elements take a scalar tail. The Pallas version staged row
// tiles of (H*W, C) in VMEM; here nothing is staged. The product and the
// sum round separately (__fmul_rn, __fadd_rn: no FMA contraction), as the
// plain version's do, so a float32 result is that of the plain version.
// The wrapper passes contiguous, 16-byte aligned tensors of one dtype.

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

__device__ __forceinline__ float film(float h, float g, float b, float t) {
  return __fadd_rn(t, fmaxf(__fadd_rn(__fmul_rn(h, g), b), 0.0f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    film_residual(const T* __restrict__ h, const T* __restrict__ gamma,
                  const T* __restrict__ beta, const T* __restrict__ trunk, T* __restrict__ out,
                  int64_t numel, int64_t hwc, int c) {
  constexpr int VEC = kVec<T>;
  const int64_t nvec = numel / VEC;
  const bool whole = c % VEC == 0;  // a vector never straddles two pixels
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < nvec; v += stride) {
    const int64_t e = v * VEC;
    Pack<T> hv, tv, ov;
    hv.u = *reinterpret_cast<const uint4*>(h + e);
    tv.u = *reinterpret_cast<const uint4*>(trunk + e);
    const int64_t b = e / hwc;
    int ch = (int)(e % c);
    if (whole) {
      Pack<T> gv, bv;
      gv.u = *reinterpret_cast<const uint4*>(gamma + b * c + ch);
      bv.u = *reinterpret_cast<const uint4*>(beta + b * c + ch);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        ov.v[j] = from_f32<T>(film(to_f32(hv.v[j]), to_f32(gv.v[j]), to_f32(bv.v[j]),
                                   to_f32(tv.v[j])));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t bj = (e + j) / hwc;
        const int cj = (int)((e + j) % c);
        ov.v[j] = from_f32<T>(film(to_f32(hv.v[j]), to_f32(gamma[bj * c + cj]),
                                   to_f32(beta[bj * c + cj]), to_f32(tv.v[j])));
      }
    }
    *reinterpret_cast<uint4*>(out + e) = ov.u;
  }
  // Scalar tail: the last numel % VEC elements (only where C is ragged).
  const int64_t tail = nvec * VEC + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (tail < numel) {
    const int64_t b = tail / hwc;
    const int ch = (int)(tail % c);
    out[tail] = from_f32<T>(film(to_f32(h[tail]), to_f32(gamma[b * c + ch]),
                                 to_f32(beta[b * c + ch]), to_f32(trunk[tail])));
  }
}

template <typename T>
int launch(const void* h, const void* gamma, const void* beta, const void* trunk, void* out,
           int batch, int hw, int c, cudaStream_t stream) {
  constexpr int VEC = kVec<T>;
  if (batch <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  const int64_t hwc = (int64_t)hw * c, numel = hwc * batch;
  const int64_t blocks = (numel / VEC + kThreads - 1) / kThreads;
  // At least one block for the tail; at most enough blocks to fill the card
  // many times over, the grid-stride loop does the rest.
  const unsigned grid = (unsigned)(blocks < 1 ? 1 : (blocks < (1 << 16) ? blocks : (1 << 16)));
  film_residual<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(trunk), static_cast<T*>(out), numel, hwc, c);
  return cudaGetLastError();
}

}  // namespace

// h, trunk, out: (batch, H, W, c) with hw = H * W; gamma, beta: (batch, c);
// all of one dtype (0 float32, 1 bfloat16), contiguous, 16-byte aligned.
extern "C" int depgan_film_residual(int dtype, const void* h, const void* gamma,
                                    const void* beta, const void* trunk, void* out, int batch,
                                    int hw, int c, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, gamma, beta, trunk, out, batch, hw, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(h, gamma, beta, trunk, out, batch, hw, c, s);
  return cudaErrorInvalidValue;
}
