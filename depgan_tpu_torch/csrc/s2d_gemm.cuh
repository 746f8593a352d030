// Implicit-GEMM engine shared by the s2d kernels of the serving and training
// paths. Bf16 K1, K2, K3 and K7 run the wgmma mainloop of s2d_wgmma.cuh
// instead; the engine's bf16 versions of them stay as the reference whose
// sum order the mainloop, the chains and the probes reproduce.
//
// Every kernel of the path is one GEMM whose rows are output positions
// (b, y, x) of a padded space-to-depth plane (batch, n+2, n+2, co4) and whose
// columns are the co4 output channels. The A operand is never built in
// memory: each k-tile is gathered from the input planes straight into shared
// memory.
//
//  - kGatherConv3x3 (conv3x3_s2d_fused, _fused_pool, _fused2): GEMM depth
//    k = (tap, dst, c) over 4 taps x 4C. With tap = 2A+B and dst = 2p+q, row
//    (b, y, x) reads x[b, y+A+p, x+B+q, (3-dst)*C + c] against weight row
//    w4[A, B, dst*C + c] — the 2x2-tap conv over the shifted s2d layout,
//    whose staging the Pallas kernel did in VMEM. A second operand (the
//    decoder skip) appends its own k range, so the concat never exists.
//  - kGatherDeconv (deconv_s2d): rows are output positions of the finer
//    level; row (b, y, x) reads input block (y/2+1, x/2+1), sub-pixel group
//    2(y%2)+(x%2), so the 2x2 stride-2 transposed conv is one per-pixel
//    matmul C -> 4O whose interleave is folded into the gather.
//  - kGatherConv5x5 (conv5x5_s2d_fused): k = (tap, c) over 9 taps x 4C with
//    tap = 3A+B; row (b, y, x) reads x[b, y+A, x+B, c] against w9[A, B, c]
//    — the SAME 5x5 pixel conv as a dense 3x3-tap conv on the padded
//    unshifted plane, with no group permutation. Its 4C may be 16, so a
//    k-tile of 32 can span two taps; the gather cursor steps over them.
//
// Products accumulate in f32: tensor cores (nvcuda::wmma 16x16x16) for bf16,
// CUDA-core FMAs for f32 (the exact indexing check). The epilogue adds the
// f32 bias, applies relu, the FiLM site (x + relu(y*gamma + beta)) or
// nothing (the backward's transposed convs), rounds once to the storage
// type, and can also emit the 2x2 max-pool of the rounded values: a pool
// window is the four channel groups of one s2d position, so a block that
// owns all co4 columns pools from shared memory. The head epilogue
// (conv3x3_s2d_fused_head) rounds the relu output to bf16 and, from shared
// memory too, applies the 1x1 head, its bias and tanh in place of the
// store. Every launch also writes the zero ring of its padded outputs.
// Each output element sums its k-products in one fixed order (bf16: k-tiles
// of 32 in order, 16 a wmma step; f32: one FMA a product, in k order, from
// 0), whatever the tile shape, so the chained kernels of chain_kernels.cu
// and the window kernels of window_kernels.cu, which reuse Mma with other
// tiles, reproduce these kernels bit for bit.
//
// Operands reach shared memory through a 3-stage cp.async pipeline of
// 16-byte copies (zero-filled past the edges), so the gather of k-tile t+2
// overlaps the products of k-tile t. This needs every gathered run of
// channels (C for the 3x3 gathers and the deconv, 4C for the 5x5) and 4Co to
// be whole 16-byte vectors, and 16-byte aligned planes, which the wrappers
// check. Outputs of at most 64 channels take 256 x 64 block tiles, wider
// ones 128 x 128 (64 x 256 for the pooled launch with 4Co = 256); f32 blocks
// take twice those rows.
//
// The f32 mainloop (Mma<float>) gives each thread a 16 x 8 register tile
// (the lanes of a warp 4 x 8 over 64 x 64 outputs; block tiles 512 x 64,
// 256 x 128 or 128 x 256, twice the bf16 rows) and reads both operands from
// shared memory as float4: A along k (4 k a load, as the gather stores it),
// B as 4 contiguous columns of a row: a 4-deep step is 24 loads for 512
// FMAs. Its k-tiles are 16 deep, so the three stages of every tile fit
// beside one block's 255 registers a thread: one block of 8 warps an SM. On the H100 that ran faster than two
// blocks of 8 x 8 tiles (16 warps, 128 registers, 32 loads for 512 FMAs):
// a 128-bit shared load takes four passes of the shared-memory pipe
// whatever it broadcasts, so the loop is bound by those passes and by
// instruction issue (~2,430 instructions a k-tile for 2,048 FMAs), not by
// latency.
//
// Bound: at the generator's shapes the GEMMs do ~300 FLOP per byte of their
// planes, near the H100's bf16 ridge; the critic's 5x5 levels (K = 144 to
// 1152, 4Co = 16 to 128) sit below it. In f32 every shape is above the
// 20 FLOP/B ridge of the CUDA cores (67 TFLOP/s FMA, 3.35 TB/s), so the f32
// engine is bound by its shared-memory passes and FMA issue; the bf16
// engine has no wgmma or TMA and stays well below both roofs (PERF.md).
//
// A Phase template argument splits the kernel for timing (the counterpart
// of scripts/kernel_anatomy.py's variants, P1). Its default, kProduction, is
// the kernel above, and every production launch takes it; the probe phases
// repeat their work `reps` times in one launch: kProbeFull the whole kernel,
// kProbeNoEpi the gather and products with a raw store (no bias, no relu),
// kProbeMatmulOnly the products over a pre-gathered dense A (the rows of
// the gathered taps), so its mainloop loads contiguous tiles, and
// kProbeStageOnly the gather into shared memory alone, which writes the sum
// of each block's staged tiles in place of an output. A rep re-reads the
// block's own tile of the input, so from the second rep on it comes from L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace depgan {

enum Gather : int { kGatherConv3x3 = 0, kGatherDeconv = 1, kGatherConv5x5 = 2 };
enum Epilogue : int { kRelu = 0, kFilm = 1, kNone = 2, kHead = 3 };
enum PoolMode : int { kPoolNone = 0, kPoolPixel = 1, kPoolS2d = 2 };
enum Phase : int {
  kProduction = 0,
  kProbeFull = 1,
  kProbeNoEpi = 2,
  kProbeMatmulOnly = 3,
  kProbeStageOnly = 4
};

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // GEMM depth of one bf16 shared-memory k-tile
constexpr int kStages = 3;     // k-tiles in flight

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// The FiLM site's epilogue, trunk + relu(y * gamma + beta), with y the conv
// output plus its bias: one FMA, so every kernel that applies it rounds alike.
__device__ __forceinline__ float film_site(float y, float gamma, float beta, float trunk) {
  return trunk + fmaxf(fmaf(y, gamma, beta), 0.f);
}

template <typename T>
struct Operand {
  const T* x;  // (batch, p_in, p_in, c4) padded s2d plane, contiguous
  const T* w;  // (k, co4) weight rows, row-major
  int c4;      // channels of x (4 sub-pixel groups of C)
  int k;       // GEMM depth: 4 * c4 (conv) or c4 / 4 (deconv)
};

template <typename T>
struct Problem {
  Operand<T> op[2];
  int n_ops;
  int gather;
  int batch;
  int n;         // interior side of the output plane; it is (n+2)^2 with the ring
  int p_in;      // side of the input planes
  int co4;
  int epilogue;
  int pool;
  const float* bias;   // (co4,)
  const float* gamma;  // (batch, co4), film only
  const float* beta;   // (batch, co4), film only
  T* out;              // (batch, n+2, n+2, co4); unused by the head
  T* pooled;           // pixel: (batch, n, n, co4/4); s2d: (batch, n/2+2, n/2+2, co4)
  const __nv_bfloat16* w_head;  // (co4, h4), head only
  const float* b_head;          // (h4,)
  float* head_out;              // (batch, n, n, h4): tanh(head), unpadded
  int h4;
};

// What a probe phase takes besides the problem.
template <typename T>
struct ProbeProblem : Problem<T> {
  int reps;          // repeats of the phase in one launch
  const T* a_dense;  // kProbeMatmulOnly: (batch*n*n, k) rows of the gathered taps
  float* sums;       // kProbeStageOnly: one sum of staged A values per block row
};

template <typename T, int PHASE>
using PhaseProblem = std::conditional_t<PHASE == kProduction, Problem<T>, ProbeProblem<T>>;

// The engine's bf16 blocks own 256 x 64, 128 x 128 or 64 x 256 outputs, its
// f32 blocks twice the rows; the chained kernels take 64 x 128 and the f32
// window kernels 128 x BN. bf16 k-tiles are kBK deep; f32 ones 16, so that
// three stages of the 512 x 64 tile take 132 KB. In f32 the depth of a
// k-tile does not change a bit: every product is one FMA in k order.
// Outputs of one engine block: 16 a thread in bf16, 128 in f32.
template <typename T>
constexpr int kBlockOutputs = std::is_same_v<T, float> ? 32768 : 16384;

template <typename T, int BN, int BM_ = kBlockOutputs<T> / BN>
struct Tile {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static constexpr int BM = BM_;
  static constexpr int BK = F32 ? 16 : kBK;
  // As[m][k]; in f32 the float4 reads of four consecutive rows at one k fall
  // in distinct banks (rows 20 words apart).
  static constexpr int LDA = BK + (F32 ? 4 : 8);
  static constexpr int LDB = BN + (F32 ? 0 : 8);  // Bs[k][n]
  static constexpr int LDC = BN + 4;              // Cs[m][n], f32, aliases the stages
  static constexpr int WM = BM / 2, WN = BN / 4;  // bf16 warp tile: 8 warps as 2 x 4
  static constexpr int kStageElems = BM * LDA + BK * LDB;
  static constexpr int kAB = kStages * kStageElems * (int)sizeof(T);
  static constexpr int kC = BM * LDC * (int)sizeof(float);
  static constexpr int kSmem = kAB > kC ? kAB : kC;
};

// 16-byte global -> shared copy; copies zeros instead when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int BN, int BM = kBlockOutputs<T> / BN> struct Mma;

// f32: CUDA-core FMAs on a register tile of TM x TN outputs a thread, fed by
// 128-bit shared loads. The 8 warps are WY x WX over the block tile; a warp's
// lanes are LY x LX, and lane (ly, lx) owns rows ly + i LY (i < TM) and the
// four-column groups 4 lx + 4 LX h (h < TN / 4) of its warp's tile. Each
// 4-deep step loads the thread's B groups at the 4 k (a quarter-warp reads
// 128 contiguous bytes of one Bs row), then row by row a float4 of A at the
// 4 k (a quarter-warp's lanes read one address, a warp's LY rows fall in
// distinct banks), and issues 4 TM TN FMAs: TM + 2 TN loads for them, 24
// for 512 at the engine's 16 x 8 tile. Each output adds its products one
// fmaf each in k order, from 0, whatever the tile.
template <int BN, int BM>
struct Mma<float, BN, BM> {
  using Tl = Tile<float, BN, BM>;
  static constexpr int LX = BN >= 32 ? 8 : BN / 4, LY = 32 / LX;
  static constexpr int TN = BN >= 64 ? 8 : 4, H = TN / 4, WTN = LX * TN;
  static constexpr int WX = BN / WTN, WY = kThreads / 32 / WX, TM = BM / WY / LY;
  static_assert(WX * WTN == BN && WY * WX * 32 == kThreads && WY * LY * TM == BM,
                "the warps and lanes must tile the block");
  static_assert(Tl::BK % 4 == 0, "a k-tile is whole 4-deep steps");
  float acc[TM][TN];

  // The thread's first row and first column in the block tile.
  __device__ __forceinline__ static int row0() {
    return threadIdx.x / 32 / WX * (LY * TM) + threadIdx.x % 32 / LX;
  }
  __device__ __forceinline__ static int col0() {
    return threadIdx.x / 32 % WX * WTN + threadIdx.x % LX * 4;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const float* a = As + row0() * Tl::LDA;
    const float* b = Bs + col0();
#pragma unroll
    for (int k = 0; k < Tl::BK; k += 4) {
      float4 bv[4][H];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < H; ++h)
          bv[kk][h] = *reinterpret_cast<const float4*>(b + (k + kk) * Tl::LDB + h * 4 * LX);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a + i * LY * Tl::LDA + k);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < H; ++h) {
            float* c = acc[i] + 4 * h;
            c[0] = fmaf(ak[kk], bv[kk][h].x, c[0]);
            c[1] = fmaf(ak[kk], bv[kk][h].y, c[1]);
            c[2] = fmaf(ak[kk], bv[kk][h].z, c[2]);
            c[3] = fmaf(ak[kk], bv[kk][h].w, c[3]);
          }
      }
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    float* c = Cs + row0() * Tl::LDC + col0();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h)
        *reinterpret_cast<float4*>(c + i * LY * Tl::LDC + h * 4 * LX) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
};

// bf16: tensor cores through wmma; each warp owns a WM x WN sub-tile of
// FM x FN 16x16 fragments (64 x 32 or 32 x 64), so each fragment load feeds
// FN or FM products.
template <int BN, int BM>
struct Mma<__nv_bfloat16, BN, BM> {
  using Tl = Tile<__nv_bfloat16, BN, BM>;
  static constexpr int FM = Tl::WM / 16, FN = Tl::WN / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * Tl::WM + i * 16) * Tl::LDA + kk, Tl::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * Tl::LDB + wn * Tl::WN + j * 16, Tl::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::store_matrix_sync(
            Cs + (wm * Tl::WM + i * 16) * Tl::LDC + wn * Tl::WN + j * 16, acc[i][j], Tl::LDC,
            nvcuda::wmma::mem_row_major);
  }
};

// Zeroes the 1-block border ring of a (batch, side, side, ch) plane in
// 16-byte stores (ch is a multiple of 16 bytes), as a grid-stride loop
// shared by all blocks of the launch.
template <typename T>
__device__ __forceinline__ void zero_ring(T* plane, int batch, int side, int ch,
                                          int64_t start, int64_t stride) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int vecs = ch / VEC, per_img = 4 * (side - 1);
  const int64_t total = (int64_t)batch * per_img * vecs;
  for (int64_t e = start; e < total; e += stride) {
    const int v = (int)(e % vecs);
    const int64_t pos = e / vecs;
    const int b = (int)(pos / per_img), r = (int)(pos % per_img);
    int row, col;
    if (r < side) {
      row = 0, col = r;
    } else if (r < 2 * side) {
      row = side - 1, col = r - side;
    } else {
      const int s = r - 2 * side;
      row = 1 + s / 2, col = (s & 1) * (side - 1);
    }
    *reinterpret_cast<uint4*>(plane + (((int64_t)b * side + row) * side + col) * ch + v * VEC) =
        make_uint4(0, 0, 0, 0);
  }
}

// f32: one block an SM, whose 16 x 8 register tiles take 255 registers.
template <typename T, int BN, int PHASE = kProduction>
__global__ void __launch_bounds__(kThreads, std::is_same_v<T, float> ? 1 : 2)
    s2d_gemm(const PhaseProblem<T, PHASE> pr) {
  using Tl = Tile<T, BN>;
  constexpr int BM = Tl::BM, BK = Tl::BK, LDA = Tl::LDA, LDB = Tl::LDB, LDC = Tl::LDC;
  constexpr int VEC = Tl::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n = pr.n, side = n + 2, nn_img = n * n;

  {
    const int64_t start = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid;
    const int64_t stride = (int64_t)gridDim.x * gridDim.y * kThreads;
    if (PHASE != kProbeStageOnly && pr.epilogue != kHead)
      zero_ring(pr.out, pr.batch, side, pr.co4, start, stride);
    if (pr.pool == kPoolS2d) zero_ring(pr.pooled, pr.batch, n / 2 + 2, pr.co4, start, stride);
  }

  const int64_t M = (int64_t)pr.batch * nn_img;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A gather: 16-byte vectors, VPR to a k-tile row; vector v of the tile is
  // row v / VPR, k-offset (v % VPR) * VEC. A thread keeps the same vectors
  // for every k-tile, so their rows' input pixels are computed once: the
  // pixel (b, y', x') of the row's tap origin (-1 past M) and the row's
  // channel offset (the deconv's sub-pixel group; 0 for the convs). Both
  // operands of a two-operand conv share the plane geometry.
  constexpr int VPR = BK / VEC, A_VECS = BM * VPR;
  constexpr int A_ITERS = (A_VECS + kThreads - 1) / kThreads;
  int a_pix[A_ITERS], a_goff[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int64_t m = m0 + (tid + i * kThreads) / VPR;
    a_pix[i] = -1;
    a_goff[i] = 0;
    if (tid + i * kThreads < A_VECS && m < M) {
      const int b = (int)(m / nn_img), rem = (int)(m % nn_img), y = rem / n, x = rem % n;
      if (pr.gather != kGatherDeconv) {  // the tap origin: padded (y, x)
        a_pix[i] = (b * pr.p_in + y) * pr.p_in + x;
      } else {
        a_pix[i] = (b * pr.p_in + y / 2 + 1) * pr.p_in + x / 2 + 1;
        a_goff[i] = (2 * (y & 1) + (x & 1)) * (pr.op[0].c4 / 4);
      }
    }
  }
  constexpr int BPR = BN / VEC, B_ITERS = BK * BPR / kThreads;
  static_assert(BK * BPR % kThreads == 0, "B tile must split evenly over the block");

  // k-tiles of operand 0, then of operand 1; a tile never spans both.
  const int kt0 = (pr.op[0].k + BK - 1) / BK;
  const int kt_total = kt0 + (pr.n_ops > 1 ? (pr.op[1].k + BK - 1) / BK : 0);

  // Tiles are loaded in order, and a thread's k-offset inside a tile is the
  // same for all its vectors (kThreads is a multiple of VPR), so its gather
  // position advances tile to tile without divisions: a cursor over
  // (operand, k, tap, unit, channel). A unit is one gathered channel run:
  // a dst group of C channels for the 3x3 gather (4 to a tap), a whole tap
  // of 4C channels for the 5x5 gather.
  static_assert(kThreads % VPR == 0, "a thread's vectors share one k-offset");
  const bool conv5 = pr.gather == kGatherConv5x5;
  const int a_kv = (tid % VPR) * VEC;
  int cur_op = 0, cur_k = a_kv, cur_tap = 0, cur_d = 0, cur_ch = 0;
  auto unit = [&](int o) { return conv5 ? pr.op[o].c4 : pr.op[o].c4 / 4; };
  auto cursor_start = [&](int o) {
    const int u = unit(o);
    cur_op = o, cur_k = a_kv, cur_tap = 0, cur_d = a_kv / u, cur_ch = a_kv % u;
  };
  cursor_start(0);

  auto load_tile = [&](int t, int stage) {
    if (t == kt0) cursor_start(1);  // the whole block moves to operand 1 together
    const Operand<T>& op = cur_op ? pr.op[1] : pr.op[0];
    const int c = unit(cur_op), k0 = cur_k - a_kv;
    int64_t off = cur_k;
    if (pr.gather == kGatherConv3x3) {
      const int dy = (cur_tap >> 1) + (cur_d >> 1), dx = (cur_tap & 1) + (cur_d & 1);
      off = ((int64_t)dy * pr.p_in + dx) * op.c4 + (3 - cur_d) * c + cur_ch;
    } else if (conv5) {  // cur_d is the tap 3A+B
      off = ((int64_t)(cur_d / 3) * pr.p_in + cur_d % 3) * op.c4 + cur_ch;
    }
    T* As = stages + stage * Tl::kStageElems;
    T* Bs = As + BM * LDA;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int v = tid + i * kThreads;
      if (v >= A_VECS) break;
      if constexpr (PHASE == kProbeMatmulOnly) {  // contiguous rows of the dense A
        const int64_t m = m0 + v / VPR;
        const bool ok = cur_k < op.k && m < M;
        cp_async16(As + (v / VPR) * LDA + a_kv, ok ? pr.a_dense + m * op.k + cur_k : pr.a_dense,
                   ok);
      } else {
        const bool ok = cur_k < op.k && a_pix[i] >= 0;
        cp_async16(As + (v / VPR) * LDA + a_kv,
                   ok ? op.x + (int64_t)a_pix[i] * op.c4 + a_goff[i] + off : op.x, ok);
      }
    }
    if constexpr (PHASE != kProbeStageOnly) {  // kProbeStageOnly: the gather alone
#pragma unroll
      for (int j = 0; j < B_ITERS; ++j) {
        const int v = tid + j * kThreads, kr = v / BPR, col = n0 + (v % BPR) * VEC;
        const bool ok = k0 + kr < op.k && col < pr.co4;
        cp_async16(Bs + kr * LDB + (v % BPR) * VEC,
                   ok ? op.w + (int64_t)(k0 + kr) * pr.co4 + col : op.w, ok);
      }
    }
    cur_k += BK;
    if (pr.gather == kGatherConv3x3) {
      for (cur_ch += BK; cur_ch >= c; cur_ch -= c) {
        if (++cur_d == 4) cur_d = 0, ++cur_tap;
      }
    } else if (conv5) {
      for (cur_ch += BK; cur_ch >= c; cur_ch -= c) ++cur_d;
    }
  };

  int reps = 1;
  if constexpr (PHASE != kProduction) reps = pr.reps;
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (PHASE != kProduction) {
      if (rep > 0) {  // the last rep's epilogue has read Cs, which aliases the stages
        __syncthreads();
        cursor_start(0);
      }
    }
    Mma<T, BN> mma;
    mma.zero();
    float staged = 0.f;  // kProbeStageOnly: this thread's staged A values, summed
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < kt_total) load_tile(s, s);
      cp_async_commit();
    }
    for (int t = 0; t < kt_total; ++t) {
      cp_async_wait<kStages - 2>();  // k-tile t has landed ...
      __syncthreads();               // ... for every thread, and tile t-1 is consumed
      const T* As = stages + (t % kStages) * Tl::kStageElems;
      if constexpr (PHASE == kProbeStageOnly) {  // the thread's own copies have landed
#pragma unroll
        for (int i = 0; i < A_ITERS; ++i) {
          const int v = tid + i * kThreads;
          if (v >= A_VECS) break;
#pragma unroll
          for (int j = 0; j < VEC; ++j) staged += to_f32(As[(v / VPR) * LDA + a_kv + j]);
        }
      } else {
        mma.step(As, As + BM * LDA);
      }
      if (t + kStages - 1 < kt_total) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (PHASE == kProbeStageOnly) {  // one sum a block row, in a fixed order
      __shared__ float warp_sums[kThreads / 32];
#pragma unroll
      for (int o = 16; o > 0; o /= 2) staged += __shfl_xor_sync(0xffffffffu, staged, o);
      if (tid % 32 == 0) warp_sums[tid / 32] = staged;
      __syncthreads();
      if (tid == 0 && blockIdx.y == 0) {
        float sum = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
        pr.sums[blockIdx.x] = sum;
      }
      continue;
    }
    mma.store(Cs);

    // Per-row offsets, once per block: the output position (-1 past M), the
    // FiLM trunk (the input at the same position), the gamma/beta row and
    // the pooled position.
    __shared__ int64_t row_out[BM], row_trunk[BM], row_pool[BM];
    __shared__ int row_gb[BM];
    // One row a thread; two in the f32 512-row tile.
    constexpr int ROW_ITERS = (BM + kThreads - 1) / kThreads;
#pragma unroll 1
    for (int i = 0; i < ROW_ITERS; ++i) {
      const int r = tid + i * kThreads;
      if (r >= BM) break;
      const int64_t m = m0 + r;
      row_out[r] = -1;
      if (m < M) {
        const int b = (int)(m / nn_img), rem = (int)(m % nn_img), y = rem / n, x = rem % n;
        const int half = n / 2 + 2, cp = pr.co4 / 4;
        row_out[r] = (((int64_t)b * side + y + 1) * side + x + 1) * pr.co4;
        row_trunk[r] = (((int64_t)b * pr.p_in + y + 1) * pr.p_in + x + 1) * pr.op[0].c4;
        row_gb[r] = b * pr.co4;
        row_pool[r] = pr.pool == kPoolPixel
                            ? (((int64_t)b * n + y) * n + x) * cp
                            : (((int64_t)b * half + y / 2 + 1) * half + x / 2 + 1) * pr.co4 +
                                  (2 * (y & 1) + (x & 1)) * cp;
      }
    }
    __syncthreads();

    // VEC consecutive columns a thread: one 16-byte store, one 16-byte trunk load.
    union Pack {
      uint4 u;
      T v[VEC];
    };
    constexpr int VPRow = BN / VEC;
    for (int e = tid; e < BM * VPRow; e += kThreads) {
      const int r = e / VPRow, cc = (e % VPRow) * VEC, col = n0 + cc;
      const int64_t ro = row_out[r];
      if (ro < 0 || col >= pr.co4) continue;
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (PHASE == kProbeNoEpi) {
          v[j] = Cs[r * LDC + cc + j];  // the raw sums: no bias, and the launch asks no relu
        } else {
          v[j] = Cs[r * LDC + cc + j] + pr.bias[col + j];
        }
      }
      if (pr.epilogue == kRelu || pr.epilogue == kHead) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = fmaxf(v[j], 0.f);
      } else if (pr.epilogue == kFilm) {  // FiLM site, the trunk being the input
        Pack t;
        t.u = *reinterpret_cast<const uint4*>(pr.op[0].x + row_trunk[r] + col);
        const int gb = row_gb[r] + col;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[j] = film_site(v[j], pr.gamma[gb + j], pr.beta[gb + j], to_f32(t.v[j]));
      }
      if (pr.epilogue == kHead) {  // the head reads the relu output rounded to bf16
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          Cs[r * LDC + cc + j] = __bfloat162float(__float2bfloat16(v[j]));
        continue;
      }
      Pack q;
#pragma unroll
      for (int j = 0; j < VEC; ++j) q.v[j] = from_f32<T>(v[j]);
      *reinterpret_cast<uint4*>(pr.out + ro + col) = q.u;
      if (pr.pool != kPoolNone) {  // pool the stored values
#pragma unroll
        for (int j = 0; j < VEC; ++j) Cs[r * LDC + cc + j] = to_f32(q.v[j]);
      }
    }

    if (pr.epilogue == kHead) {  // the launcher guarantees n0 == 0 and BN >= co4
      __syncthreads();
      for (int e = tid; e < BM * pr.h4; e += kThreads) {
        const int r = e / pr.h4, h = e % pr.h4;
        if (row_out[r] < 0) continue;
        const float* row = Cs + r * LDC;
        float acc = 0.f;
        for (int c = 0; c < pr.co4; ++c)
          acc = fmaf(row[c], __bfloat162float(pr.w_head[c * pr.h4 + h]), acc);
        pr.head_out[(m0 + r) * pr.h4 + h] = tanhf(acc + pr.b_head[h]);
      }
    }

    if (pr.pool != kPoolNone) {  // the launcher guarantees n0 == 0 and BN >= co4
      __syncthreads();
      const int cp = pr.co4 / 4;
      for (int e = tid; e < BM * cp; e += kThreads) {
        const int r = e / cp, ch = e % cp;
        if (row_out[r] < 0) continue;
        const float* row = Cs + r * LDC;
        pr.pooled[row_pool[r] + ch] = from_f32<T>(
            fmaxf(fmaxf(row[ch], row[cp + ch]), fmaxf(row[2 * cp + ch], row[3 * cp + ch])));
      }
    }
  }  // reps
}

template <typename T, int BN, int PHASE = kProduction>
cudaError_t launch_tile(const PhaseProblem<T, PHASE>& pr, cudaStream_t stream) {
  constexpr int smem = Tile<T, BN>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      s2d_gemm<T, BN, PHASE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int64_t M = (int64_t)pr.batch * pr.n * pr.n;
  const dim3 grid((unsigned)((M + Tile<T, BN>::BM - 1) / Tile<T, BN>::BM),
                  (unsigned)((pr.co4 + BN - 1) / BN));
  s2d_gemm<T, BN, PHASE><<<grid, kThreads, smem, stream>>>(pr);
  return cudaGetLastError();
}

// Launches one problem; returns cudaGetLastError() after the launch.
template <typename T>
cudaError_t launch(const Problem<T>& pr, cudaStream_t stream) {
  if (pr.batch <= 0 || pr.n <= 0 || pr.co4 <= 0 || pr.co4 % 8 != 0) return cudaErrorInvalidValue;
  // Whole 16-byte vectors in every gather: the gathered run (C, or 4C for
  // the 5x5) a multiple of 8 elements.
  const int run = pr.gather == kGatherConv5x5 ? 8 : 32;
  for (int o = 0; o < pr.n_ops; ++o)
    if (pr.op[o].c4 % run != 0) return cudaErrorInvalidValue;
  if (pr.pool == kPoolNone && pr.epilogue != kHead)
    return pr.co4 <= 64 ? launch_tile<T, 64>(pr, stream) : launch_tile<T, 128>(pr, stream);
  // The fused pool and the head need every output channel of a position in
  // one block.
  if (pr.pool == kPoolS2d && pr.n % 2 != 0) return cudaErrorInvalidValue;
  if (pr.co4 <= 128) return launch_tile<T, 128>(pr, stream);
  if (pr.co4 <= 256) return launch_tile<T, 256>(pr, stream);
  return cudaErrorInvalidValue;
}

}  // namespace depgan
