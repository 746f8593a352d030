// The s2d GEMM kernels for Hopper (sm_90a): the C entry points over the
// implicit-GEMM engine of s2d_gemm.cuh and, for bf16 K1, K2, K3, K7 and K9,
// the wgmma mainloop of s2d_wgmma.cuh (wgmma_kernels.cu), for bf16 K4 its
// deconv kernel (wgmma_deconv.cu). An engine launch fills
// one Problem: s2d_gemm<T, 64> for outputs of at most 64 channels,
// s2d_gemm<T, 128> otherwise, and s2d_gemm<T, 256> for the pooled conv with
// 4Co = 256.
//
// Replaces the Pallas kernels of depgan_tpu/ops/conv_s2d_pallas.py:
//  - conv3x3_s2d_fused (:758, kernel _kernel :490): a 3x3 SAME conv on a
//    padded s2d plane (batch, n+2, n+2, 4C) -> (batch, n+2, n+2, 4Co), with
//    the epilogue relu(y + b), the whole FiLM site x + relu((y+b)*g + beta),
//    or y + b ('none': the transposed convs of the training backward). On the
//    serving path at n = 128 (c4 32 or 128 -> 128) and n = 64 (128 or
//    256 -> 256); the backward adds the same shapes with c4 and 4Co swapped.
//    The Pallas kernel staged the shifted taps once per plane in VMEM; here
//    the tap gather is folded into the shared-memory load of each GEMM
//    k-tile, so nothing is staged in device memory either.
//  - conv3x3_s2d_fused_pool (:1043, kernel _kernel_pool :1022): the relu conv
//    that also writes the 2x2 max-pool of its stored output, either as the
//    next level's padded s2d plane or in the pixel domain. Its blocks own
//    every channel group of their positions: the engine pools from shared
//    memory, the wgmma mainloop from registers.
//  - conv3x3_s2d_fused_head (:1145, kernel _kernel mode 'head' :589-606):
//    the relu conv of p1's conv_out with the generator's 1x1 head in the
//    epilogue: tanh(bf16(relu(y + b)) @ bf16(W_head) + b_head), summed in
//    f32, written unpadded (batch, n, n, h4) in f32. The engine's blocks own
//    all co4 columns (128 x 128 tiles at 4Co = 128) and apply the head from
//    shared memory, h4 dot products of 4Co a position on the CUDA cores; the
//    full-channel plane is never stored. At p1 (n = 128, 4C = 4Co = 128,
//    h4 = 4) the conv is K = 512 deep and the bound is its bytes.
//  - conv3x3_s2d_fused2 (:1289, kernel _kernel2 :1217): relu(conv(x1, W1) +
//    conv(x2, W2) + b), the decoder's first conv over concat(up, skip)
//    without the concat. The two operands are two k ranges of one GEMM, so
//    both convs accumulate in the same f32 registers. On the serving path:
//    p2 at n = 64 (384 + 256 -> 256) and p1 at n = 128 (256 + 128 -> 128),
//    the two deepest GEMMs of the forward (K = 2560 and 1536).
//  - deconv_s2d_pallas (:408, kernel _deconv_kernel :328): the 2x2 stride-2
//    transposed conv + bias + relu from a padded s2d plane (batch, m+2, m+2,
//    4C) into the next finer level's padded s2d plane (batch, 2m+2, 2m+2, 4O):
//      out[b, 2i+p+1, 2j+q+1, :] = relu(x[b, i+1, j+1, (2p+q)C:(2p+q+1)C] @ w2 + b4)
//    On the serving path the p2 -> p1 upsample (m = 64, C = 64, 4O = 256). A
//    K = 64 GEMM: about 64 FLOP per byte of its bf16 output plane, far below
//    the H100's ~300 FLOP/B ridge, so its bound is the plane traffic. Each
//    engine GEMM row is one output position whose gather picks the input
//    group, so the sub-pixel interleave costs nothing.
//  - conv5x5_s2d_fused (:1918 -> _conv5_impl :1940, kernel _kernel5 :1863):
//    the critic's SAME 5x5 convs as 9 dense taps over the padded unshifted
//    plane, relu or none (the transposed convs of the WGAN-GP input
//    gradient). At image 256 the critic's levels are n = 128 (4C 16 or 64
//    -> 64) and n = 64 (64 or 128 -> 128), and the transposes run 64 -> 16,
//    64 -> 64, 128 -> 64 and 128 -> 128. K = 9 * 4C is 144 to 1152 and 4Co
//    at most 128: about 40-140 FLOP per byte of bf16 planes, under the
//    ridge, so these GEMMs are bound by their planes' traffic; 4Co <= 64
//    takes 256 x 64 tiles so that a block's columns are not mostly padding.
//
// K1, K2, K3, K7 and K9 take the wgmma mainloop in bf16, K4 the wgmma
// deconv, and all of them the engine in float32, whose CUDA-core FMAs are
// the exact indexing check; a bf16 shape the wgmma kernels refuse is an
// error of these entry points, never an engine launch.
// depgan_conv3x3_s2d_engine (K1, K2, K3), depgan_conv5x5_s2d_engine (K7),
// depgan_conv3x3_s2d_fused_head_engine (K9) and depgan_deconv_s2d_engine
// (K4) launch the engine in either dtype: the float32 path of those entry
// points and, in bf16, the reference that the wgmma kernels, the chains
// (K10, K12) and the probes P1 and P2 sum like. In bf16 the wrappers call
// the engine's K2 at 4Co the wgmma pool does not take (not 32, 64, 128 or
// 256) and its K4 where the wgmma deconv's plan refuses, as the Python
// width rule (ops/conv_s2d.py, kernel_route) decides before the launch.
//
// dtype: 0 = float32, 1 = bfloat16. Every entry point returns
// cudaGetLastError() after its launch, or an error code for arguments the
// engine does not take.

#include <type_traits>

#include "s2d_gemm.cuh"
#include "s2d_wgmma.cuh"

namespace {

using namespace depgan;

// Launches the problem that fill(Problem<T>&) describes, for the storage
// type T that dtype names.
template <typename Fill>
int dispatch(int dtype, void* stream, const Fill& fill) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Problem<float> pr{};
    fill(pr);
    return launch(pr, s);
  }
  if (dtype == 1) {
    Problem<__nv_bfloat16> pr{};
    fill(pr);
    return launch(pr, s);
  }
  return cudaErrorInvalidValue;
}

template <typename P>
using Elem = std::remove_pointer_t<decltype(P::out)>;

}  // namespace

// The engine's K1 (x2 == nullptr; with a pool, K2) or K3 (relu) in either
// dtype: what depgan_conv3x3_s2d_fused and depgan_conv3x3_s2d_fused2 launch
// in float32, and launched in bf16 before the wgmma mainloop took them over.
// epilogue: 0 = relu, 1 = film, 2 = none. pool: 0 = none, 1 = pixel, 2 = s2d.
extern "C" int depgan_conv3x3_s2d_engine(int dtype, const void* x1, const void* x2,
                                         const void* w1, const void* w2, const void* bias,
                                         const void* gamma, const void* beta, void* out,
                                         void* pooled, int batch, int n, int c4a, int c4b,
                                         int co4, int epilogue, int pool, void* stream) {
  const bool two = x2 != nullptr;
  if (epilogue != kRelu && epilogue != kFilm && epilogue != kNone) return cudaErrorInvalidValue;
  if (epilogue == kFilm && (two || c4a != co4 || gamma == nullptr || beta == nullptr))
    return cudaErrorInvalidValue;
  if (two && epilogue != kRelu) return cudaErrorInvalidValue;
  if (pool != kPoolNone && pool != kPoolPixel && pool != kPoolS2d) return cudaErrorInvalidValue;
  if (pool != kPoolNone && (two || epilogue != kRelu || pooled == nullptr))
    return cudaErrorInvalidValue;
  return dispatch(dtype, stream, [&](auto& pr) {
    using T = Elem<std::remove_reference_t<decltype(pr)>>;
    pr.op[0] = {static_cast<const T*>(x1), static_cast<const T*>(w1), c4a, 4 * c4a};
    pr.op[1] = {static_cast<const T*>(x2), static_cast<const T*>(w2), c4b, 4 * c4b};
    pr.n_ops = two ? 2 : 1;
    pr.gather = kGatherConv3x3;
    pr.batch = batch;
    pr.n = n;
    pr.p_in = n + 2;
    pr.co4 = co4;
    pr.epilogue = epilogue;
    pr.pool = pool;
    pr.bias = static_cast<const float*>(bias);
    pr.gamma = static_cast<const float*>(gamma);
    pr.beta = static_cast<const float*>(beta);
    pr.out = static_cast<T*>(out);
    pr.pooled = static_cast<T*>(pooled);
  });
}

extern "C" int depgan_conv3x3_s2d_fused(int dtype, const void* x, const void* w4,
                                        const void* bias, const void* gamma, const void* beta,
                                        void* out, void* pooled, int batch, int n, int c4,
                                        int co4, int epilogue, int pool, void* stream) {
  if (dtype != 1)
    return depgan_conv3x3_s2d_engine(dtype, x, nullptr, w4, nullptr, bias, gamma, beta, out,
                                     pooled, batch, n, c4, 0, co4, epilogue, pool, stream);
  if (epilogue == kFilm && (gamma == nullptr || beta == nullptr)) return cudaErrorInvalidValue;
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w4);
  cv.c4[0] = c4;
  cv.gather = kGatherConv3x3, cv.n_ops = 1, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = epilogue, cv.pool = pool;
  cv.bias = static_cast<const float*>(bias);
  cv.gamma = static_cast<const float*>(gamma);
  cv.beta = static_cast<const float*>(beta);
  cv.out = static_cast<__nv_bfloat16*>(out);
  cv.pooled = static_cast<__nv_bfloat16*>(pooled);
  return wg::conv(cv, static_cast<cudaStream_t>(stream));
}

extern "C" int depgan_conv3x3_s2d_fused2(int dtype, const void* x1, const void* x2,
                                         const void* w1, const void* w2, const void* bias,
                                         void* out, int batch, int n, int c4a, int c4b, int co4,
                                         void* stream) {
  if (dtype != 1)
    return depgan_conv3x3_s2d_engine(dtype, x1, x2, w1, w2, bias, nullptr, nullptr, out,
                                     nullptr, batch, n, c4a, c4b, co4, kRelu, kPoolNone, stream);
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x1);
  cv.x[1] = static_cast<const __nv_bfloat16*>(x2);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w1);
  cv.w[1] = static_cast<const __nv_bfloat16*>(w2);
  cv.c4[0] = c4a, cv.c4[1] = c4b;
  cv.gather = kGatherConv3x3, cv.n_ops = 2, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = kRelu, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.out = static_cast<__nv_bfloat16*>(out);
  return wg::conv(cv, static_cast<cudaStream_t>(stream));
}

// The engine's K9 in either dtype: what depgan_conv3x3_s2d_fused_head
// launches in float32, and launched in bf16 before the wgmma mainloop took it
// over. w_head: (co4, h4) bf16, b_head: (h4,) f32, out: (batch, n, n, h4) f32.
extern "C" int depgan_conv3x3_s2d_fused_head_engine(int dtype, const void* x, const void* w4,
                                                    const void* bias, const void* w_head,
                                                    const void* b_head, void* out, int batch,
                                                    int n, int c4, int co4, int h4,
                                                    void* stream) {
  if (w_head == nullptr || b_head == nullptr || out == nullptr || h4 <= 0 || h4 > 16)
    return cudaErrorInvalidValue;
  return dispatch(dtype, stream, [&](auto& pr) {
    using T = Elem<std::remove_reference_t<decltype(pr)>>;
    pr.op[0] = {static_cast<const T*>(x), static_cast<const T*>(w4), c4, 4 * c4};
    pr.n_ops = 1;
    pr.gather = kGatherConv3x3;
    pr.batch = batch;
    pr.n = n;
    pr.p_in = n + 2;
    pr.co4 = co4;
    pr.epilogue = kHead;
    pr.pool = kPoolNone;
    pr.bias = static_cast<const float*>(bias);
    pr.w_head = static_cast<const __nv_bfloat16*>(w_head);
    pr.b_head = static_cast<const float*>(b_head);
    pr.head_out = static_cast<float*>(out);
    pr.h4 = h4;
  });
}

extern "C" int depgan_conv3x3_s2d_fused_head(int dtype, const void* x, const void* w4,
                                             const void* bias, const void* w_head,
                                             const void* b_head, void* out, int batch, int n,
                                             int c4, int co4, int h4, void* stream) {
  if (dtype != 1)
    return depgan_conv3x3_s2d_fused_head_engine(dtype, x, w4, bias, w_head, b_head, out, batch,
                                                n, c4, co4, h4, stream);
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w4);
  cv.c4[0] = c4;
  cv.gather = kGatherConv3x3, cv.n_ops = 1, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = kHead, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.w_head = static_cast<const __nv_bfloat16*>(w_head);
  cv.b_head = static_cast<const float*>(b_head);
  cv.head_out = static_cast<float*>(out);
  cv.h4 = h4;
  return wg::conv(cv, static_cast<cudaStream_t>(stream));
}

// The engine's K4 in either dtype: what depgan_deconv_s2d launches in
// float32, and launched in bf16 before the wgmma deconv took it over.
extern "C" int depgan_deconv_s2d_engine(int dtype, const void* x, const void* w2,
                                        const void* bias, void* out, int batch, int m, int c4,
                                        int o4, void* stream) {
  return dispatch(dtype, stream, [&](auto& pr) {
    using T = Elem<std::remove_reference_t<decltype(pr)>>;
    pr.op[0] = {static_cast<const T*>(x), static_cast<const T*>(w2), c4, c4 / 4};
    pr.n_ops = 1;
    pr.gather = kGatherDeconv;
    pr.batch = batch;
    pr.n = 2 * m;
    pr.p_in = m + 2;
    pr.co4 = o4;
    pr.epilogue = kRelu;
    pr.pool = kPoolNone;
    pr.bias = static_cast<const float*>(bias);
    pr.out = static_cast<T*>(out);
  });
}

extern "C" int depgan_deconv_s2d(int dtype, const void* x, const void* w2, const void* bias,
                                 void* out, int batch, int m, int c4, int o4, void* stream) {
  if (dtype != 1)
    return depgan_deconv_s2d_engine(dtype, x, w2, bias, out, batch, m, c4, o4, stream);
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w2);
  cv.c4[0] = c4;
  cv.gather = kGatherDeconv, cv.n_ops = 1, cv.batch = batch, cv.n = 2 * m, cv.co4 = o4;
  cv.epilogue = kRelu, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.out = static_cast<__nv_bfloat16*>(out);
  return wg::deconv(cv, static_cast<cudaStream_t>(stream));
}

// The engine's K7 in either dtype: what depgan_conv5x5_s2d_fused launches
// in float32, and launched in bf16 before the wgmma mainloop took it over.
// w9: (3, 3, c4, co4) rows of the transformed 5x5 kernel. epilogue: 0 = relu,
// 2 = none.
extern "C" int depgan_conv5x5_s2d_engine(int dtype, const void* x, const void* w9,
                                         const void* bias, void* out, int batch, int n, int c4,
                                         int co4, int epilogue, void* stream) {
  if (epilogue != kRelu && epilogue != kNone) return cudaErrorInvalidValue;
  return dispatch(dtype, stream, [&](auto& pr) {
    using T = Elem<std::remove_reference_t<decltype(pr)>>;
    pr.op[0] = {static_cast<const T*>(x), static_cast<const T*>(w9), c4, 9 * c4};
    pr.n_ops = 1;
    pr.gather = kGatherConv5x5;
    pr.batch = batch;
    pr.n = n;
    pr.p_in = n + 2;
    pr.co4 = co4;
    pr.epilogue = epilogue;
    pr.pool = kPoolNone;
    pr.bias = static_cast<const float*>(bias);
    pr.out = static_cast<T*>(out);
  });
}

extern "C" int depgan_conv5x5_s2d_fused(int dtype, const void* x, const void* w9,
                                        const void* bias, void* out, int batch, int n, int c4,
                                        int co4, int epilogue, void* stream) {
  if (dtype != 1)
    return depgan_conv5x5_s2d_engine(dtype, x, w9, bias, out, batch, n, c4, co4, epilogue,
                                     stream);
  if (epilogue != kRelu && epilogue != kNone) return cudaErrorInvalidValue;
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w9);
  cv.c4[0] = c4;
  cv.gather = kGatherConv5x5, cv.n_ops = 1, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = epilogue, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.out = static_cast<__nv_bfloat16*>(out);
  return wg::conv(cv, static_cast<cudaStream_t>(stream));
}

extern "C" const char* depgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
