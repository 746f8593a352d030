// The kernel probes for Hopper (sm_90a): the timing splits and relayouts
// that the JAX package's scripts/ ran as Pallas kernels.
//
// Replaces:
//  - P1, run_variant (scripts/kernel_anatomy.py:108, pallas_call :123) over
//    k_full :80, k_matmul_only :90 and k_stage_only :97: K1's relu conv split
//    into its phases, each repeated `reps` times in one launch, so that the
//    marginal cost of a phase is (t(5) - t(1)) / 4, in float32; bf16 P1 runs
//    the phases on K1's wgmma mainloop (wgmma_kernels.cu), and this bf16 route
//    stays as the reference timed beside it (probes.kernel_anatomy_engine).
//    Here the phases are the Phase argument of the engine's kernel
//    (s2d_gemm.cuh): full, no_epi (no bias or relu, a raw store of the f32
//    sums), matmul_only (the products
//    over the pre-gathered taps, contiguous tiles) and stage_only (the
//    gather into shared memory alone). A rep re-reads its block's tile of the
//    input, which the first rep has brought into L2: the marginals are
//    L2-fed, not HBM-fed.
//  - P3, pallas_deint (scripts/packed_tap_probe.py:109, pallas_call :110)
//    over k_reshape_idx :92 and k_merge_cast :101: the column deinterleave
//    (batch, n, 2m, c) -> (batch, n, m, 2c), even columns in [:c], odd in
//    [c:]. deint_reshape_idx decodes each output vector's (row, j, k, c) and
//    loads x[row, 2j+k, c]; deint_merge copies the plane as flat 16-byte
//    vectors, since on a row-major layout the merge of (2m, c) into (m, 2c)
//    is the identity on memory. Both read and write each byte once: the
//    bound is 2 x bytes over the HBM rate.
//
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or an error code for arguments the kernels do not take.

#include "s2d_gemm.cuh"

namespace {

using namespace depgan;

template <typename T, int BN, int PHASE>
cudaError_t launch_probe(const void* x, const void* a_dense, const void* w4, const void* bias,
                         void* out, void* sums, int batch, int n, int c4, int co4, int reps,
                         cudaStream_t stream) {
  ProbeProblem<T> pr{};
  pr.op[0] = {static_cast<const T*>(x), static_cast<const T*>(w4), c4, 4 * c4};
  pr.n_ops = 1;
  pr.gather = kGatherConv3x3;
  pr.batch = batch;
  pr.n = n;
  pr.p_in = n + 2;
  pr.co4 = co4;
  pr.epilogue = PHASE == kProbeNoEpi ? kNone : kRelu;
  pr.pool = kPoolNone;
  pr.bias = static_cast<const float*>(bias);
  pr.out = static_cast<T*>(out);
  pr.reps = reps;
  pr.a_dense = static_cast<const T*>(a_dense);
  pr.sums = static_cast<float*>(sums);
  return launch_tile<T, BN, PHASE>(pr, stream);
}

// The engine's tile for the problem (as launch() picks it for K1).
template <typename T, int PHASE>
cudaError_t launch_phase(int co4, const void* x, const void* a_dense, const void* w4,
                         const void* bias, void* out, void* sums, int batch, int n, int c4,
                         int reps, cudaStream_t stream) {
  if (co4 <= 64)
    return launch_probe<T, 64, PHASE>(x, a_dense, w4, bias, out, sums, batch, n, c4, co4, reps,
                                      stream);
  return launch_probe<T, 128, PHASE>(x, a_dense, w4, bias, out, sums, batch, n, c4, co4, reps,
                                     stream);
}

template <typename T>
cudaError_t launch_anatomy(int phase, const void* x, const void* a_dense, const void* w4,
                           const void* bias, void* out, void* sums, int batch, int n, int c4,
                           int co4, int reps, cudaStream_t stream) {
  switch (phase) {
    case kProbeFull:
      return launch_phase<T, kProbeFull>(co4, x, a_dense, w4, bias, out, sums, batch, n, c4, reps,
                                         stream);
    case kProbeNoEpi:
      return launch_phase<T, kProbeNoEpi>(co4, x, a_dense, w4, bias, out, sums, batch, n, c4,
                                          reps, stream);
    case kProbeMatmulOnly:
      return launch_phase<T, kProbeMatmulOnly>(co4, x, a_dense, w4, bias, out, sums, batch, n,
                                               c4, reps, stream);
    case kProbeStageOnly:
      return launch_phase<T, kProbeStageOnly>(co4, x, a_dense, w4, bias, out, sums, batch, n,
                                              c4, reps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// One output vector a thread, as a grid-stride loop: its (row, j, k, cv) is
// decoded and x[row, 2j+k, cv] loaded.
__global__ void deint_reshape_idx(const uint4* __restrict__ x, uint4* __restrict__ out,
                                  int64_t rows, int m, int cv) {
  const int64_t total = rows * m * 2 * cv;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % cv), k = (int)(e / cv % 2), j = (int)(e / (2 * cv) % m);
    const int64_t row = e / ((int64_t)2 * cv * m);
    out[e] = x[(row * 2 * m + 2 * j + k) * cv + c];
  }
}

// The merge: a flat copy of 16-byte vectors.
__global__ void deint_merge(const uint4* __restrict__ x, uint4* __restrict__ out, int64_t total) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x)
    out[e] = x[e];
}

}  // namespace

// P1. phase: 1 = full, 2 = no_epi, 3 = matmul_only (reads a_dense, the
// (batch*n*n, 4*c4) gathered taps, not x), 4 = stage_only (writes sums, one
// float a block row of the engine's tile, not out). The relu conv's
// arguments as depgan_conv3x3_s2d_fused.
extern "C" int depgan_s2d_gemm_probe(int dtype, int phase, const void* x, const void* a_dense,
                                     const void* w4, const void* bias, void* out, void* sums,
                                     int batch, int n, int c4, int co4, int reps, void* stream) {
  if (batch <= 0 || n <= 0 || c4 <= 0 || c4 % 32 != 0 || co4 <= 0 || co4 % 8 != 0 || reps < 1)
    return cudaErrorInvalidValue;
  if ((phase == kProbeMatmulOnly && a_dense == nullptr) ||
      (phase == kProbeStageOnly && sums == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_anatomy<float>(phase, x, a_dense, w4, bias, out, sums, batch, n, c4, co4, reps,
                                 s);
  if (dtype == 1)
    return launch_anatomy<__nv_bfloat16>(phase, x, a_dense, w4, bias, out, sums, batch, n, c4,
                                         co4, reps, s);
  return cudaErrorInvalidValue;
}

// P3. kind: 0 = reshape_idx, 1 = merge. x (rows, 2m, c), out (rows, m, 2c),
// with c_bytes, the bytes of c elements, a multiple of 16; both 16-byte
// aligned.
extern "C" int depgan_deint(int kind, const void* x, void* out, long long rows, int m,
                            int c_bytes, void* stream) {
  if (rows <= 0 || m <= 0 || c_bytes <= 0 || c_bytes % 16 != 0 || (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  const int cv = c_bytes / 16;
  const int64_t total = (int64_t)rows * m * 2 * cv;
  const int64_t blocks64 = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(blocks64 < (1 << 30) ? blocks64 : (1 << 30));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xv = static_cast<const uint4*>(x);
  auto* ov = static_cast<uint4*>(out);
  if (kind == 0)
    deint_reshape_idx<<<blocks, kThreads, 0, s>>>(xv, ov, rows, m, cv);
  else
    deint_merge<<<blocks, kThreads, 0, s>>>(xv, ov, total);
  return cudaGetLastError();
}
