// Chained s2d 3x3 convs for Hopper (sm_90a): two or three convs of one
// generator site in one launch, the intermediate planes kept in shared
// memory, never in device memory.
//
// Replaces the Pallas kernels of depgan_tpu/ops/conv_s2d_pallas.py:
//  - conv3x3_s2d_chain3 (:1741, kernel _kernel_chain3 :1610): a whole site,
//    conv_in (one operand, or the two-operand decoder conv over (up, skip))
//    -> FiLM site -> conv_out, with the 2x2 max-pool of conv_out when asked.
//    On the serving forward under fuse_chain: m1 (n 128, 32 -> 128 -> 128,
//    pool s2d), m2 (n 64, 128 -> 256 -> 256, pool pixel), p2 (n 64,
//    384 + 256 -> 256 -> 256) and p1 (n 128, 256 + 128 -> 128 -> 128).
//  - conv3x3_s2d_chain2 (:1511, kernel _kernel_chain2 :1435): two chained
//    convs, each epilogue relu, film or none (at most one film, whose trunk
//    is that stage's own input).
//
// The Pallas kernels hold whole planes in VMEM, one batch element a grid
// step. A level-1 intermediate at batch 42 is 182 MB and a block has 227 KB
// of shared memory, so here a block owns a T x T tile of output positions
// of one image and recomputes the halo each conv reads: with S stages,
// stage s (0-based) computes its output on (T + 2 (S-1-s))^2 positions, one
// ring more than the next stage reads. Stage 0 gathers from the input
// planes in device memory; later stages gather from the previous stage's
// region in shared memory. Positions of a region that fall on the padded
// plane's border ring (or outside it) hold zeros, as the sequential path's
// stored planes do, so every conv sees SAME padding.
//
// Each stage is a GEMM over its region's positions (64 x 128 block tiles,
// the engine's Mma: wmma for bf16, FMAs for f32), k-tiles of the engine's
// depth (32 bf16, 16 f32) gathered into shared memory behind the same
// 3-stage cp.async pipeline as s2d_gemm.cuh (the weights stream from L2).
// Each output element sums its products in the engine's order (the two
// operands of stage 0 one after the other, as conv3x3_s2d_fused2 does) and
// its epilogue rounds where the sequential kernels store, so the chain
// reproduces the sequential kernels (K1 -> K1 film -> K1/K2, or K3 -> K1
// film -> K1) bit for bit.
//
// T is 8 where the two regions and the staging fit in shared memory
// (bf16: 166 KB at 4Cm = 256, 104 KB at 128), else 4 (f32 at 4Cm = 256).
// The halo costs FLOPs: at T = 8 with three stages, the first conv runs on
// 144 and the FiLM conv on 100 positions for every 64 outputs (padded to
// whole 64-row tiles: 192 and 128), twice the sequential kernels' products
// at the generator's sites. In exchange the two intermediate planes never
// reach device memory: 4 plane passes a site, ~2.2 GB a serving forward at
// batch 42. Bound: at the generator's shapes each site does ~300-900 FLOP
// per byte of its input and output planes, above the H100's bf16 ridge, so
// its bound is its operations; this version, like the engine, has no wgmma
// or TMA (PERF.md).
//
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or an error code for arguments the kernel does not take.

#include <type_traits>

#include "s2d_gemm.cuh"

namespace {

using namespace depgan;

constexpr int kBM = 64, kBN = 128;  // GEMM tile of a chain stage
constexpr int kMaxStages = 3;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on the H100

template <typename T>
struct ChainStage {
  const T* w[2];  // (4 * c4[o], co4) weight rows of each operand
  int c4[2];      // input channels of each operand
  int n_ops;
  int co4;
  int mode;  // kRelu, kFilm (trunk: the stage's input at the position), kNone
  const float* bias;  // (co4,)
};

template <typename T>
struct Chain {
  using Elem = T;
  const T* x[2];  // stage 0's operands: padded planes (batch, n+2, n+2, c4)
  ChainStage<T> st[kMaxStages];
  int n_stages;
  int batch, n;
  int tile, tiles;     // output tile side T, tiles along a side
  const float* gamma;  // (batch, co4 of the film stage)
  const float* beta;
  int pool;
  T* out;     // (batch, n+2, n+2, co4 of the last stage)
  T* pooled;  // pixel: (batch, n, n, co4/4); s2d: (batch, n/2+2, n/2+2, co4)
  int region1;        // element offset of the second region in shared memory
  int staging_bytes;  // byte offset of the GEMM staging
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) s2d_chain(const Chain<T> ch) {
  using Tl = Tile<T, kBN, kBM>;
  constexpr int BM = kBM, BN = kBN, BK = Tl::BK, LDA = Tl::LDA, LDB = Tl::LDB, LDC = Tl::LDC;
  constexpr int VEC = Tl::VEC, VPR = BK / VEC, A_VECS = BM * VPR;
  constexpr int A_ITERS = A_VECS / kThreads, BPR = BN / VEC, B_ITERS = BK * BPR / kThreads;
  static_assert(A_VECS % kThreads == 0 && BK * BPR % kThreads == 0, "tiles split evenly");
  static_assert(kThreads % VPR == 0, "a thread's A vectors share one k-offset");
  union Pack {
    uint4 u;
    T v[VEC];
  };

  extern __shared__ __align__(128) unsigned char smem[];
  T* regions[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + ch.region1};
  T* stages = reinterpret_cast<T*>(smem + ch.staging_bytes);
  float* Cs = reinterpret_cast<float*>(smem + ch.staging_bytes);

  const int tid = threadIdx.x, n = ch.n, P = n + 2, b = blockIdx.y;
  const int Y0 = 1 + (int)(blockIdx.x / ch.tiles) * ch.tile;
  const int X0 = 1 + (int)(blockIdx.x % ch.tiles) * ch.tile;
  const int co4_out = ch.st[ch.n_stages - 1].co4;
  {
    const int64_t start = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid;
    const int64_t stride = (int64_t)gridDim.x * gridDim.y * kThreads;
    zero_ring(ch.out, ch.batch, P, co4_out, start, stride);
    if (ch.pool == kPoolS2d) zero_ring(ch.pooled, ch.batch, n / 2 + 2, co4_out, start, stride);
  }
  const int a_kv = (tid % VPR) * VEC;  // this thread's k-offset in every A k-tile

  for (int s = 0; s < ch.n_stages; ++s) {
    const ChainStage<T>& st = ch.st[s];
    const bool first = s == 0, last = s == ch.n_stages - 1;
    const int halo = ch.n_stages - 1 - s;
    const int side = ch.tile + 2 * halo, M = side * side;  // this stage's region
    const int oy = Y0 - halo, ox = X0 - halo;              // its origin in the plane
    // The source: stage 0's planes in device memory, or the previous
    // stage's region (side + 2, origin one ring further out).
    const int src_side = first ? P : side + 2;
    const T* region_in = first ? nullptr : regions[(s - 1) & 1];
    T* region_out = last ? nullptr : regions[s & 1];
    const int kt0 = st.c4[0] * 4 / BK;
    const int kt_total = kt0 + (st.n_ops > 1 ? st.c4[1] * 4 / BK : 0);

    for (int m0 = 0; m0 < M; m0 += BM) {
      // This thread's A rows: the tap origin of each, or -1 for a row that
      // is past the region or off the plane's interior (it gathers zeros).
      int a_base[A_ITERS];
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int p = m0 + (tid + i * kThreads) / VPR;
        const int ry = p / side, rx = p % side, Y = oy + ry, X = ox + rx;
        const bool ok = p < M && Y >= 1 && Y <= n && X >= 1 && X <= n;
        a_base[i] = !ok ? -1 : first ? (b * P + Y - 1) * P + X - 1 : ry * src_side + rx;
      }

      for (int n0 = 0; n0 < st.co4; n0 += BN) {
        auto load_tile = [&](int t, int stage) {
          const int o = t < kt0 ? 0 : 1, k0 = (t < kt0 ? t : t - kt0) * BK;
          const int c4 = st.c4[o], c = c4 / 4, k = k0 + a_kv;
          const int tap = k / c4, rem = k - tap * c4, dst = rem / c, chn = rem - dst * c;
          const int dy = (tap >> 1) + (dst >> 1), dx = (tap & 1) + (dst & 1);
          const int64_t off = ((int64_t)dy * src_side + dx) * c4 + (3 - dst) * c + chn;
          T* As = stages + stage * Tl::kStageElems;
          T* Bs = As + BM * LDA;
#pragma unroll
          for (int i = 0; i < A_ITERS; ++i) {
            T* dst_a = As + ((tid + i * kThreads) / VPR) * LDA + a_kv;
            const bool ok = a_base[i] >= 0;
            if (first) {
              const T* x = ch.x[o];
              cp_async16(dst_a, ok ? x + (int64_t)a_base[i] * c4 + off : x, ok);
            } else {
              *reinterpret_cast<uint4*>(dst_a) =
                  ok ? *reinterpret_cast<const uint4*>(region_in + a_base[i] * c4 + off)
                     : make_uint4(0, 0, 0, 0);
            }
          }
          const T* w = st.w[o];
#pragma unroll
          for (int j = 0; j < B_ITERS; ++j) {
            const int v = tid + j * kThreads, kr = v / BPR, cv = (v % BPR) * VEC;
            const bool ok = n0 + cv < st.co4;
            cp_async16(Bs + kr * LDB + cv, ok ? w + (int64_t)(k0 + kr) * st.co4 + n0 + cv : w,
                       ok);
          }
        };

        Mma<T, BN, BM> mma;
        mma.zero();
#pragma unroll
        for (int t = 0; t < kStages - 1; ++t) {
          if (t < kt_total) load_tile(t, t);
          cp_async_commit();
        }
        for (int t = 0; t < kt_total; ++t) {
          cp_async_wait<kStages - 2>();
          __syncthreads();
          const T* As = stages + (t % kStages) * Tl::kStageElems;
          mma.step(As, As + BM * LDA);
          if (t + kStages - 1 < kt_total) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
          cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();
        mma.store(Cs);
        __syncthreads();

        // Epilogue: bias, relu / FiLM / none, one rounding; into the next
        // region (zeros off the interior) or, at the last stage, the output.
        for (int e = tid; e < BM * BPR; e += kThreads) {
          const int r = e / BPR, cc = (e % BPR) * VEC, col = n0 + cc, p = m0 + r;
          if (p >= M || col >= st.co4) continue;
          const int ry = p / side, rx = p % side, Y = oy + ry, X = ox + rx;
          const bool interior = Y >= 1 && Y <= n && X >= 1 && X <= n;
          Pack q;
          if (!interior) {
            if (last) continue;
            q.u = make_uint4(0, 0, 0, 0);
          } else {
            float v[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = Cs[r * LDC + cc + j] + st.bias[col + j];
            if (st.mode == kRelu) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) v[j] = fmaxf(v[j], 0.f);
            } else if (st.mode == kFilm) {  // the trunk: this stage's input here
              Pack t;
              t.u = *reinterpret_cast<const uint4*>(
                  first ? ch.x[0] + ((int64_t)(b * P + Y) * P + X) * st.c4[0] + col
                        : region_in + ((ry + 1) * src_side + rx + 1) * st.c4[0] + col);
              const int gb = b * st.co4 + col;
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                v[j] = film_site(v[j], ch.gamma[gb + j], ch.beta[gb + j], to_f32(t.v[j]));
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) q.v[j] = from_f32<T>(v[j]);
          }
          T* dst = last ? ch.out + ((int64_t)(b * P + Y) * P + X) * st.co4
                        : region_out + p * st.co4;
          *reinterpret_cast<uint4*>(dst + col) = q.u;
        }
        __syncthreads();  // Cs aliases the staging of the next tile
      }
    }
  }

  // The 2x2 max-pool of the stored output: a window is the four channel
  // groups of one position, which this block wrote above.
  if (ch.pool != kPoolNone) {
    const int cp = co4_out / 4, T2 = ch.tile * ch.tile, half = n / 2 + 2;
    for (int e = tid; e < T2 * cp; e += kThreads) {
      const int pos = e / cp, c = e % cp;
      const int Y = Y0 + pos / ch.tile, X = X0 + pos % ch.tile;
      if (Y > n || X > n) continue;
      const T* row = ch.out + ((int64_t)(b * P + Y) * P + X) * co4_out;
      const float m = fmaxf(fmaxf(to_f32(row[c]), to_f32(row[cp + c])),
                            fmaxf(to_f32(row[2 * cp + c]), to_f32(row[3 * cp + c])));
      const int y = Y - 1, x = X - 1;
      const int64_t at =
          ch.pool == kPoolPixel
              ? ((int64_t)(b * n + y) * n + x) * cp + c
              : ((int64_t)(b * half + y / 2 + 1) * half + x / 2 + 1) * co4_out +
                    (2 * (y & 1) + (x & 1)) * cp + c;
      ch.pooled[at] = from_f32<T>(m);
    }
  }
}

// Shared memory of a launch with output tile side `tile`: the two regions,
// then the staging (16-byte aligned). Sets the chain's offsets.
template <typename T>
int chain_smem(Chain<T>& ch, int tile) {
  const int s0 = tile + 2 * (ch.n_stages - 1), s1 = tile + 2 * (ch.n_stages - 2);
  const int64_t r0 = (int64_t)s0 * s0 * ch.st[0].co4;
  const int64_t r1 = ch.n_stages == 3 ? (int64_t)s1 * s1 * ch.st[1].co4 : 0;
  const int64_t regions = ((r0 + r1) * (int64_t)sizeof(T) + 127) / 128 * 128;
  const int64_t total = regions + Tile<T, kBN, kBM>::kSmem;
  if (total > kSmemLimit) return -1;
  ch.region1 = (int)r0;
  ch.staging_bytes = (int)regions;
  return (int)total;
}

template <typename T>
cudaError_t launch_chain(Chain<T>& ch, cudaStream_t stream) {
  int smem = -1;
  for (int tile = 8; tile >= 1 && smem < 0; tile /= 2) {
    ch.tile = tile;
    smem = chain_smem(ch, tile);
  }
  if (smem < 0) return cudaErrorInvalidValue;
  ch.tiles = (ch.n + ch.tile - 1) / ch.tile;
  const cudaError_t attr =
      cudaFuncSetAttribute(s2d_chain<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  s2d_chain<T><<<dim3((unsigned)(ch.tiles * ch.tiles), (unsigned)ch.batch), kThreads, smem,
                 stream>>>(ch);
  return cudaGetLastError();
}

}  // namespace

// Stage 0: x1 (c4a) [+ x2 (c4b), when x2 is given] -> c4m with mode1 and
// bias b1. Stage 1: c4m -> (w3 ? c4m : c4o) with mode2 and b2. Stage 2,
// when w3 is given: c4m -> c4o with mode3 and b3. Modes: 0 = relu, 1 =
// film, 2 = none; gamma, beta (batch, co4 of the film stage). pool: 0 =
// none, 1 = pixel, 2 = s2d, of the last stage's stored output.
extern "C" int depgan_conv3x3_s2d_chain(int dtype, const void* x1, const void* x2,
                                        const void* w1a, const void* w1b, const void* b1,
                                        const void* w2, const void* b2, const void* w3,
                                        const void* b3, const void* gamma, const void* beta,
                                        void* out, void* pooled, int batch, int n, int c4a,
                                        int c4b, int c4m, int c4o, int mode1, int mode2,
                                        int mode3, int pool, void* stream) {
  const int n_stages = w3 != nullptr ? 3 : 2;
  const int modes[3] = {mode1, mode2, mode3};
  const int c4_in[3] = {c4a, c4m, c4m};
  const int c4_out[3] = {c4m, n_stages == 3 ? c4m : c4o, c4o};
  if (batch <= 0 || n <= 0 || pool < kPoolNone || pool > kPoolS2d) return cudaErrorInvalidValue;
  if ((pool != kPoolNone) != (pooled != nullptr) || (pool == kPoolS2d && n % 2 != 0))
    return cudaErrorInvalidValue;
  if (x2 != nullptr && (w1b == nullptr || c4b <= 0 || c4b % 32 != 0)) return cudaErrorInvalidValue;
  for (int s = 0; s < n_stages; ++s) {
    if (modes[s] != kRelu && modes[s] != kFilm && modes[s] != kNone) return cudaErrorInvalidValue;
    // Gathered runs of whole 16-byte vectors; an intermediate is gathered too.
    if (c4_in[s] % 32 != 0 || c4_out[s] % 8 != 0 || (s + 1 < n_stages && c4_out[s] % 32 != 0))
      return cudaErrorInvalidValue;
    if (modes[s] == kFilm && (c4_in[s] != c4_out[s] || (s == 0 && x2 != nullptr) ||
                              gamma == nullptr || beta == nullptr))
      return cudaErrorInvalidValue;
  }
  const auto fill = [&](auto& ch) {
    using T = typename std::remove_reference_t<decltype(ch)>::Elem;
    const void* ws[3] = {w1a, w2, w3};
    const void* bs[3] = {b1, b2, b3};
    ch.x[0] = static_cast<const T*>(x1);
    ch.x[1] = static_cast<const T*>(x2);
    ch.n_stages = n_stages;
    for (int s = 0; s < n_stages; ++s) {
      auto& st = ch.st[s];
      st.w[0] = static_cast<const T*>(ws[s]);
      st.c4[0] = c4_in[s];
      st.n_ops = 1;
      st.co4 = c4_out[s];
      st.mode = modes[s];
      st.bias = static_cast<const float*>(bs[s]);
    }
    if (x2 != nullptr) {
      ch.st[0].w[1] = static_cast<const T*>(w1b);
      ch.st[0].c4[1] = c4b;
      ch.st[0].n_ops = 2;
    }
    ch.batch = batch;
    ch.n = n;
    ch.gamma = static_cast<const float*>(gamma);
    ch.beta = static_cast<const float*>(beta);
    ch.pool = pool;
    ch.out = static_cast<T*>(out);
    ch.pooled = static_cast<T*>(pooled);
  };
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Chain<float> ch{};
    fill(ch);
    return launch_chain(ch, s);
  }
  if (dtype == 1) {
    Chain<__nv_bfloat16> ch{};
    fill(ch);
    return launch_chain(ch, s);
  }
  return cudaErrorInvalidValue;
}
