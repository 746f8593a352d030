// Window convs for Hopper (sm_90a): each block stages the input rows that
// its output rows read into shared memory once, with 16-byte cp.async
// copies, and builds every k-tile of its implicit GEMM from there: no
// further global reads of the input plane.
//
// Replaces:
//  - K11, _conv5_impl with _kernel5_packed (depgan_tpu/ops/conv_s2d_pallas.py
//    :1940, kernel :1889), which CONV5_PACKED selects for 4C <= 64: K7's
//    function, relu or none (conv5x5_SAME(x, w5) + b) over the padded
//    unshifted s2d plane, as one K = 9*4C deep product. The Pallas kernel
//    stages the 9 taps once, lane-concatenated, and runs one wide matmul a
//    strip. Here a block owns R whole output rows (R*n <= 128 GEMM rows; a
//    chunk of 128 columns where n > 128) and a slice of 4Co, stages its
//    (R+2) x (n+2) x 4C window once, and gathers tap (A, B) of every
//    k-tile from it at row offset A and column offset B, where K7 re-gathers
//    each k-tile from L2. The weights stream through shared memory in
//    k-tiles behind a 3-stage cp.async pipeline (W9 for a 64-wide slice of
//    4Co is 74 KB in bf16, twice that in f32). The N tile follows 4Co (16,
//    32, 64, or 128), so the critic's transposed L0a conv (4Co = 16) runs no
//    padding columns. At the critic's shapes (n 128 and 64, 4C 16 and 64,
//    4Co 16 to 128) the product is 40-140 FLOP per byte of its bf16 planes,
//    under the H100's ridge: the bound is the planes' traffic.
//  - P2, conv3x3_rowblk (scripts/rowblk_probe.py:125, kernel _kernel_rowblk
//    :54), in float32; bf16 P2 runs rowblk_wgmma (wgmma_kernels.cu), and this
//    bf16 route stays as the reference timed beside it
//    (probes.conv3x3_rowblk_window). K1's relu conv with a row-blocked
//    output grid (batch, n_blocks),
//    block s owning padded output rows [s*rows_blk, (s+1)*rows_blk), ring
//    rows included. The block walks its rows R at a time over a rolling
//    window of R+2 input rows, so each input row is loaded once per block,
//    runs the 4 taps of the shifted-s2d 3x3 gather from shared memory, and
//    computes every column tile of 4Co from the same window.
//
// The window: R+2 input rows of W+2 pixels (a ring of R+2 row slots for
// P2's rolling walk), each pixel's 4C channels padded by 16 bytes in bf16
// so that ldmatrix's eight rows a phase fall in distinct banks. In bf16 the
// A fragments are read straight from it: each lane of a warp gives
// ldmatrix the window address of its fragment row at its 8-deep k-half, so
// nothing is copied per k-tile and a 16-deep step may span two taps (4C =
// 8) or two channel groups. Products are mma.sync m16n8k16, the
// instruction the engine's wmma 16x16x16 step issues, one a 16-deep step in
// k order (k-tiles of 32 in order): each output sums its products in the
// engine's order, so K11 equals K7 and P2 equals K1 bit for bit. In f32
// each A k-tile is copied from the window into the engine's A layout and
// the engine's FMA Mma runs on it, in the same order.
//
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or an error code for arguments the kernels do not take.

#include <type_traits>

#include "s2d_gemm.cuh"

namespace {

using namespace depgan;

constexpr int kWinBM = 128;         // GEMM rows of a block: R output rows of W positions
constexpr int kSmemLimit = 232448;  // shared memory a block may use on the H100

enum WinGather : int { kWinConv3x3 = 0, kWinConv5x5 = 1 };

template <typename T>
struct WinConv {
  const T* x;         // (batch, n+2, n+2, c4) padded s2d plane
  const T* w;         // (k, co4) weight rows
  const float* bias;  // (co4,)
  T* out;             // (batch, n+2, n+2, co4)
  int batch, n, c4, co4;
  int k;               // GEMM depth: 4*c4 (3x3 gather) or 9*c4 (5x5 gather)
  int gather, epilogue;
  int rows, cols;          // a GEMM: `rows` output rows of `cols` positions
  int wrow;                // GEMM rows an output row takes: cols, rounded up to 16 in bf16
  int pitch;               // elements of a window pixel: c4, padded by 16 bytes in bf16
  int blk_rows, blk_off;   // block s: interior rows [s*blk_rows - blk_off, +blk_rows) of [0, n)
  int row_blocks, col_chunks;
  int cols_per_block;      // output channels a block computes, in N tiles
  int win_bytes;           // shared memory of the window and a zero vector, 128-byte aligned
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bf16 products on the tensor cores, A read straight from the window. The
// warp grid is fitted to the N tile (8 x 1 warps at BN = 16 ... 2 x 4 at BN
// >= 64). Each 16 x 16 A fragment comes from one ldmatrix.x4 whose 32 row
// addresses each lane computes: row = lane % 16 of the fragment, k-half =
// lane / 16, so a 16-deep step may span two taps or two channel groups.
// B comes from the staged k-tile with ldmatrix.x4.trans. Each output sums
// one mma.sync m16n8k16 a 16-deep step, in k order: the instruction the
// engine's wmma 16x16x16 step issues, in the engine's order.
template <int BN>
struct WinMmaDirect {
  using Tl = Tile<__nv_bfloat16, BN, kWinBM>;
  static constexpr int WARPS_N = BN / 16 < 4 ? BN / 16 : 4, WARPS_M = 8 / WARPS_N;
  static constexpr int WM = kWinBM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 8;
  float acc[FM][FN][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  // One 16-deep step: a_addr[i], this lane's row address of A fragment i;
  // Bs the k-tile at the step's first row.
  __device__ __forceinline__ void step(const unsigned (&a_addr)[FM], const __nv_bfloat16* Bs) {
    const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % WARPS_N;
    unsigned b[FN][2];
#pragma unroll
    for (int j = 0; j < FN; j += 2) {
      const __nv_bfloat16* row =
          Bs + ((lane & 7) + ((lane >> 3) & 1) * 8) * Tl::LDB + wn * WN + j * 8 + (lane >> 4) * 8;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
                   : "r"(smem_u32(row)));
    }
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      unsigned a[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                   : "r"(a_addr[i]));
#pragma unroll
      for (int j = 0; j < FN; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]), "+f"(acc[i][j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[j][0]), "r"(b[j][1]));
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int r = wm * WM + i * 16 + (lane >> 2), c = wn * WN + j * 8 + (lane & 3) * 2;
        Cs[r * Tl::LDC + c] = acc[i][j][0];
        Cs[r * Tl::LDC + c + 1] = acc[i][j][1];
        Cs[(r + 8) * Tl::LDC + c] = acc[i][j][2];
        Cs[(r + 8) * Tl::LDC + c + 1] = acc[i][j][3];
      }
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2) window_conv(const WinConv<T> p) {
  // bf16 reads A straight from the window; f32 copies each A k-tile from
  // the window into the engine's A layout and runs the engine's FMA Mma.
  constexpr bool kDirect = std::is_same_v<T, __nv_bfloat16>;
  using Tl = Tile<T, BN, kWinBM>;
  constexpr int BM = kWinBM, BK = Tl::BK, LDA = Tl::LDA, LDB = Tl::LDB, LDC = Tl::LDC;
  constexpr int VEC = Tl::VEC, VPR = BK / VEC, A_ITERS = BM * VPR / kThreads;
  constexpr int BPR = BN / VEC, B_VECS = BK * BPR;
  static_assert(BM * VPR % kThreads == 0, "A tile must split evenly over the block");
  static_assert(kThreads % VPR == 0, "a thread's A vectors share one k-offset");
  using Direct = WinMmaDirect<BN>;
  constexpr int FM = kDirect ? Direct::FM : 1;
  union Pack {
    uint4 u;
    T v[VEC];
  };

  extern __shared__ __align__(128) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const T* zero16 = reinterpret_cast<const T*>(smem + p.win_bytes - 16);  // k past the depth
  T* abuf = reinterpret_cast<T*>(smem + p.win_bytes);  // 2 x BM x LDA (f32 only)
  T* bst = abuf + (kDirect ? 0 : 2 * BM * LDA);          // kStages x BK x LDB
  float* Cs = reinterpret_cast<float*>(smem + p.win_bytes);  // aliases abuf and bst

  const int tid = threadIdx.x, n = p.n, P = n + 2, c4 = p.c4, W = p.cols, S = p.rows + 2;
  const int pitch = p.pitch, wrow = p.wrow;
  const int s = blockIdx.x / p.col_chunks, x0 = (blockIdx.x % p.col_chunks) * W;
  const int xw = min(W, n - x0);  // this block's columns [x0, x0 + xw)
  const int ya = max(s * p.blk_rows - p.blk_off, 0);
  const int yb = min((s + 1) * p.blk_rows - p.blk_off, n);  // its interior rows [ya, yb)
  const int nc_lo = blockIdx.y * p.cols_per_block, nc_hi = min(nc_lo + p.cols_per_block, p.co4);
  const T* x = p.x + (int64_t)blockIdx.z * P * P * c4;
  T* out = p.out + (int64_t)blockIdx.z * P * P * p.co4;
  if (tid == 0) *reinterpret_cast<uint4*>(smem + p.win_bytes - 16) = make_uint4(0, 0, 0, 0);

  // This block's share of the zero ring, in its channels: padded rows 0 and
  // n+1 where its rows reach them, and columns 0 and n+1 of its rows.
  {
    const int vecs = (nc_hi - nc_lo) / VEC;
    const int cx_lo = x0 == 0 ? 0 : x0 + 1, cx_hi = x0 + xw == n ? n + 2 : x0 + xw + 1;
    auto zero_rect = [&](int r0, int r1, int c0, int c1) {
      const int cols = c1 - c0, total = (r1 - r0) * cols * vecs;
      for (int e = tid; e < total; e += kThreads) {
        const int px = e / vecs, r = r0 + px / cols, c = c0 + px % cols;
        *reinterpret_cast<uint4*>(out + ((int64_t)r * P + c) * p.co4 + nc_lo + (e % vecs) * VEC) =
            make_uint4(0, 0, 0, 0);
      }
    };
    if (ya == 0) zero_rect(0, 1, cx_lo, cx_hi);
    if (yb == n) zero_rect(n + 1, n + 2, cx_lo, cx_hi);
    if (x0 == 0) zero_rect(ya + 1, yb + 1, 0, 1);
    if (x0 + xw == n) zero_rect(ya + 1, yb + 1, n + 1, n + 2);
  }

  const int kt_total = (p.k + BK - 1) / BK;
  const int vpp = c4 / VEC;  // 16-byte vectors a pixel
  // The window offset (dy, dx, channel) of GEMM depth k: k = (tap, dst, c)
  // over 4 taps for the 3x3 gather (tap = 2A+B reads group 3-dst at offset
  // (A+p, B+q)), k = (tap, c) over 9 taps for the 5x5 gather (tap = 3A+B at
  // (A, B)).
  auto decode = [&](int k, int& dy, int& dx, int& ch) {
    const int tap = k / c4, rem = k - tap * c4;
    if (p.gather == kWinConv5x5) {
      dy = tap / 3, dx = tap % 3, ch = rem;
    } else {
      const int c = c4 / 4, dst = rem / c;
      dy = (tap >> 1) + (dst >> 1), dx = (tap & 1) + (dst & 1), ch = (3 - dst) * c + rem % c;
    }
  };

  int loaded_hi = ya;  // input rows [.., loaded_hi) are in the window
  for (int y = ya; y < yb; y += p.rows) {
    const int rg = min(p.rows, yb - y);  // output rows y .. y+rg-1 read input rows y .. y+rg+1
    const int r_lo = max(y, loaded_hi), r_hi = y + rg + 2;
    __syncthreads();  // every thread is done with the slots about to be refilled
    const int row_vecs = (W + 2) * vpp;
    for (int e = tid; e < (r_hi - r_lo) * row_vecs; e += kThreads) {
      const int r = r_lo + e / row_vecs, j = (e % row_vecs) / vpp, cv = e % vpp;
      const bool ok = x0 + j <= n + 1;
      cp_async16(win + ((r % S) * (W + 2) + j) * pitch + cv * VEC,
                 ok ? x + ((int64_t)r * P + x0 + j) * c4 + cv * VEC : x, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    loaded_hi = r_hi;

    // The GEMM rows this thread reads A for: the window slot of the row's
    // tap origin and its column. A row past the group or the plane reads
    // what lies there (its output is never stored); in bf16 the lane's row
    // of each fragment, in f32 the rows of its copied vectors.
    int a_slot[kDirect ? FM : A_ITERS], a_rx[kDirect ? FM : A_ITERS];
#pragma unroll
    for (int i = 0; i < (kDirect ? FM : A_ITERS); ++i) {
      int m;
      if constexpr (kDirect) {
        m = (tid / 32 / Direct::WARPS_N) * Direct::WM + i * 16 + tid % 16;
      } else {
        m = (tid + i * kThreads) / VPR;
      }
      const int ry = m / wrow, rx = m % wrow;
      a_slot[i] = kDirect || (ry < rg && rx < xw) ? (y + ry) % S : -1;
      a_rx[i] = rx;
    }

    for (int n0 = nc_lo; n0 < nc_hi; n0 += BN) {
      auto load_b = [&](int t, int stage) {
        T* Bs = bst + stage * BK * LDB;
        const int k0 = t * BK;
        for (int v = tid; v < B_VECS; v += kThreads) {
          const int kr = v / BPR, col = n0 + (v % BPR) * VEC;
          const bool ok = k0 + kr < p.k && col < p.co4;
          cp_async16(Bs + kr * LDB + (v % BPR) * VEC,
                     ok ? p.w + (int64_t)(k0 + kr) * p.co4 + col : p.w, ok);
        }
      };
      // f32: k-tile t of A copied from the window into the engine's layout.
      auto build_a = [&](int t, T* As) {
        const int k = t * BK + (tid % VPR) * VEC;
        int dy = 0, dx = 0, ch = 0;
        if (k < p.k) decode(k, dy, dx, ch);
#pragma unroll
        for (int i = 0; i < A_ITERS; ++i) {
          uint4 val = make_uint4(0, 0, 0, 0);
          if (k < p.k && a_slot[i] >= 0) {
            int slot = a_slot[i] + dy;
            if (slot >= S) slot -= S;
            val = *reinterpret_cast<const uint4*>(win + (slot * (W + 2) + a_rx[i] + dx) * pitch + ch);
          }
          *reinterpret_cast<uint4*>(As + ((tid + i * kThreads) / VPR) * LDA + (tid % VPR) * VEC) =
              val;
        }
      };
      // bf16: this lane's row addresses of A for the 16-deep step at depth
      // k0 (its k-half's offset; the zero vector past the depth).
      auto a_rows = [&](int k0, unsigned (&addr)[FM]) {
        const int k = k0 + (tid % 32 / 16) * 8;
        int dy = 0, dx = 0, ch = 0;
        if (k < p.k) decode(k, dy, dx, ch);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          int slot = a_slot[i] + dy;
          if (slot >= S) slot -= S;
          addr[i] = smem_u32(k < p.k ? win + (slot * (W + 2) + a_rx[i] + dx) * pitch + ch
                                     : zero16);
        }
      };

      std::conditional_t<kDirect, Direct, Mma<T, BN, kWinBM>> mma;
      mma.zero();
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < kt_total) load_b(t, t);
        cp_async_commit();
      }
      for (int t = 0; t < kt_total; ++t) {
        T* As = abuf + (t & 1) * BM * LDA;  // read two k-tiles ago, before the last barrier
        if constexpr (!kDirect) build_a(t, As);
        cp_async_wait<kStages - 2>();  // B k-tile t has landed ...
        __syncthreads();               // ... for every thread, and k-tile t-1 is consumed
        const T* Bs = bst + (t % kStages) * BK * LDB;
        if constexpr (kDirect) {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            unsigned addr[FM];
            a_rows(t * BK + kk, addr);
            mma.step(addr, Bs + kk * LDB);
          }
        } else {
          mma.step(As, Bs);
        }
        if (t + kStages - 1 < kt_total) load_b(t + kStages - 1, (t + kStages - 1) % kStages);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      mma.store(Cs);
      __syncthreads();

      // Bias, relu or none, one rounding; VEC columns a thread, 16-byte stores.
      for (int e = tid; e < BM * BPR; e += kThreads) {
        const int r = e / BPR, cc = (e % BPR) * VEC, col = n0 + cc, ry = r / wrow, rx = r % wrow;
        if (ry >= rg || rx >= xw || col >= p.co4) continue;
        Pack q;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float v = Cs[r * LDC + cc + j] + p.bias[col + j];
          if (p.epilogue == kRelu) v = fmaxf(v, 0.f);
          q.v[j] = from_f32<T>(v);
        }
        *reinterpret_cast<uint4*>(out + ((int64_t)(y + ry + 1) * P + x0 + rx + 1) * p.co4 + col) =
            q.u;
      }
      __syncthreads();  // Cs aliases the staging of the next N tile
    }
  }
}

// Fits the GEMM's rows to shared memory (R output rows of W positions, R
// lowered until the window fits beside the staging) and launches. The
// window holds (R+2) x (W+2) pixels, 16 more that the rows past a plane's
// last column may reach, and a zero vector.
template <typename T, int BN>
cudaError_t launch_window(WinConv<T>& p, cudaStream_t stream) {
  using Tl = Tile<T, BN, kWinBM>;
  constexpr bool direct = std::is_same_v<T, __nv_bfloat16>;
  constexpr int staging =
      ((direct ? 0 : 2 * kWinBM * Tl::LDA) + kStages * Tl::BK * Tl::LDB) * (int)sizeof(T);
  constexpr int cs = kWinBM * Tl::LDC * (int)sizeof(float);
  constexpr int64_t rest = staging > cs ? staging : cs;
  // bf16: pixels 16 bytes apart from a multiple of 128, so ldmatrix's eight
  // rows a phase fall in distinct banks; rows of 16 GEMM positions.
  p.pitch = direct ? p.c4 + 8 : p.c4;
  p.wrow = direct ? (p.cols + 15) / 16 * 16 : p.cols;
  p.rows = kWinBM / p.wrow;
  int64_t win = 0;
  for (; p.rows >= 1; --p.rows) {
    const int64_t pixels = (int64_t)(p.rows + 2) * (p.cols + 2) + 16;
    win = (pixels * p.pitch * (int64_t)sizeof(T) + 16 + 127) / 128 * 128;
    if (win + rest <= kSmemLimit) break;
  }
  if (p.rows < 1) return cudaErrorInvalidValue;
  if (p.blk_rows <= 0) p.blk_rows = p.rows;  // one GEMM row group a block
  p.row_blocks = (p.n + 2 * p.blk_off + p.blk_rows - 1) / p.blk_rows;  // rows, or padded rows
  p.win_bytes = (int)win;
  const int smem = (int)(win + rest);
  const cudaError_t attr =
      cudaFuncSetAttribute(window_conv<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)(p.row_blocks * p.col_chunks),
                  (unsigned)((p.co4 + p.cols_per_block - 1) / p.cols_per_block), (unsigned)p.batch);
  window_conv<T, BN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The shape of the problem; blk_rows 0 gives each block one row group.
// n_tile: the N tile (16, 32, 64 or 128); all_columns: a block computes
// every column tile of 4Co from one window (P2), else one N tile (K11).
template <typename T>
cudaError_t launch_conv(const void* x, const void* w, const void* bias, void* out, int batch,
                        int n, int c4, int co4, int gather, int epilogue, int blk_rows,
                        int blk_off, int n_tile, bool all_columns, cudaStream_t stream) {
  WinConv<T> p{};
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<T*>(out);
  p.batch = batch, p.n = n, p.c4 = c4, p.co4 = co4;
  p.k = (gather == kWinConv5x5 ? 9 : 4) * c4;
  p.gather = gather, p.epilogue = epilogue;
  p.cols = n < kWinBM ? n : kWinBM;
  p.col_chunks = (n + p.cols - 1) / p.cols;
  p.blk_rows = blk_rows, p.blk_off = blk_off;
  p.cols_per_block = all_columns ? co4 : n_tile;
  switch (n_tile) {
    case 16: return launch_window<T, 16>(p, stream);
    case 32: return launch_window<T, 32>(p, stream);
    case 64: return launch_window<T, 64>(p, stream);
    case 128: return launch_window<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename... Args>
int dispatch_conv(int dtype, Args... args) {
  if (dtype == 0) return launch_conv<float>(args...);
  if (dtype == 1) return launch_conv<__nv_bfloat16>(args...);
  return cudaErrorInvalidValue;
}

}  // namespace

// K11. w9: (9*c4, co4) rows of the transformed 5x5 kernel; epilogue 0 =
// relu, 2 = none. Takes 4C and 4Co multiples of 8.
extern "C" int depgan_conv5x5_s2d_packed(int dtype, const void* x, const void* w9,
                                         const void* bias, void* out, int batch, int n, int c4,
                                         int co4, int epilogue, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || c4 <= 0 || co4 <= 0 || c4 % 8 != 0 ||
      co4 % 8 != 0 || (epilogue != kRelu && epilogue != kNone))
    return cudaErrorInvalidValue;
  const int n_tile = co4 <= 16 ? 16 : co4 <= 32 ? 32 : co4 <= 64 ? 64 : 128;
  return dispatch_conv(dtype, x, w9, bias, out, batch, n, c4, co4, (int)kWinConv5x5, epilogue, 0,
                       0, n_tile, false, static_cast<cudaStream_t>(stream));
}

// P2. w4: (4*c4, co4) rows of the s2d 3x3 kernel; relu; block s owns padded
// rows [s*(n+2)/n_blocks, (s+1)*(n+2)/n_blocks). Takes 4C multiples of 32
// and 4Co multiples of 8, and n_blocks dividing n+2.
extern "C" int depgan_conv3x3_rowblk(int dtype, const void* x, const void* w4, const void* bias,
                                     void* out, int batch, int n, int c4, int co4, int n_blocks,
                                     void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || c4 <= 0 || co4 <= 0 || c4 % 32 != 0 ||
      co4 % 8 != 0 || n_blocks <= 0 || (n + 2) % n_blocks != 0)
    return cudaErrorInvalidValue;
  return dispatch_conv(dtype, x, w4, bias, out, batch, n, c4, co4, (int)kWinConv3x3, (int)kRelu,
                       (n + 2) / n_blocks, 1, co4 <= 64 ? 64 : 128, true,
                       static_cast<cudaStream_t>(stream));
}
