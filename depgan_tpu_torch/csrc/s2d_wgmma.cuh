// The bf16 wgmma mainloop of K1 (conv3x3_s2d_fused: relu, film, none), K2
// (its pooled form, conv3x3_s2d_fused_pool), K3 (conv3x3_s2d_fused2), K7
// (conv5x5_s2d_fused: relu, none) and K9 (K1's relu conv with the 1x1 head
// in its epilogue, conv3x3_s2d_fused_head) for Hopper (sm_90a): what the
// host and the kernel share. The kernel is in wgmma_kernels.cu; the
// kernels of K11, K10 and K4 on the same machinery, whose plans are here
// too, in wgmma_conv5.cu, wgmma_chain.cu and wgmma_deconv.cu.
//
// The GEMMs are the engine's (s2d_gemm.cuh): rows m = (b, y, x) are output
// positions, and the gather decides what depth k of row m reads.
//  - kGatherConv3x3 (K1, K2, K3): k = (tap, dst, c) over 4 taps x 4C of each
//    operand, operand 1's k range after operand 0's; x[b, y+dy, x+dx,
//    (3-dst)*C + c] of the padded plane with dy = (tap>>1) + (dst>>1),
//    dx = (tap&1) + (dst&1).
//  - kGatherConv5x5 (K7): k = (tap, c) over 9 taps x 4C; x[b, y+dy, x+dx, c]
//    with dy = tap / 3, dx = tap % 3.
//
// A block owns BM rows and BN columns: every output column up to 4Co = 256,
// so each A k-tile is loaded once (4Co = 384 takes two blocks of 192), and
// BM = 256 where BN <= 128, else 128. Its k-tiles are kBK = 64 deep and pass
// through a ring of kStages shared-memory stages guarded by full and empty
// mbarriers: one producer warpgroup loads, two consumer warpgroups each
// multiply BM/2 rows, one or two wgmma m64nBNk16 a 16-deep step (A and B
// from shared memory through matrix descriptors), into float32 registers.
//
// A k-tile of A is two 32-deep halves, each BM rows x 64 bytes in the
// 64-byte-swizzled K-major layout. Where a half is one channel chunk of one
// tap group (a group is C channels of the 3x3 gather, 4C of the 5x5) and K is
// a whole number of k-tiles, the BM rows of a tile read a box of the plane
// (B, P, P, 4C) viewed as a 4-d tensor (4C, P, P, B):
//   extents (32, bx, by, bb), origin (c, x0 + dx, y0 + dy, b0)
// with (x0, y0, b0) the tile's first position: one image row of 128 at
// n = 128 and BM = 128, two rows of 128 or four of 64 at BM 256, several
// images when n*n < BM. Such a launch loads A by TMA (route kRouteTma).
// Otherwise (K1's C = 8 entry conv, K7's 4C = 16 entry conv, or n neither a
// multiple nor a divisor of 128) the producer warpgroup gathers A, 128 rows a
// tile, in 16-byte cp.async copies into the same layout (route
// kRouteCpAsync), copying zeros past K where K is no whole k-tile (the 5x5 at
// 4C = 16: K = 144 of 192). B, the weight rows (k, 4Co), arrives by TMA in
// 64 x 64 boxes, 128-byte swizzled, N-major, zeros past K and past 4Co. The
// route is fixed at launch by geometry(); ops/wgmma_plan.py is its mirror in
// Python, which the CPU tests check against the plain gathers and
// chip_smoke.py against this header.
//
// K2's pool needs every column of a row in one block (n_blocks 1): a 2 x 2
// pool window is the four channel groups of one s2d position. It takes 4Co
// = 32, 64, 128 or 256 (the generator's widths at first_fm 8 to 32), where a
// lane's runs of 8 columns after the epilogue's transpose lie each in one
// group at the same channels over the column loop; other widths are refused.
// K9's head (epilogue kHead) needs them in one block too, any 4Co <= 256: it
// sums W_head's columns in the engine's order, one head column's chain a
// lane of the quad that holds a row, and stores tanh of each of the h4 <= 16
// sums, not the relu plane.
//
// The probes run the same mainloop. P1 (kernel_anatomy) is the kernel's
// Phase argument (the engine's enum, s2d_gemm.cuh): K1's relu launch split
// into full, no_epi, matmul_only (A from the dense gathered taps by 2-d TMA
// boxes) and stage_only (the producer's A loads alone), each repeated reps
// times a tile; production is kProduction. P2 (conv3x3_rowblk) is a kernel
// of its own, rowblk_wgmma: the row-blocked relu conv over a ring of input
// rows staged once a work unit (Window below), with K1's tile, B ring, sum
// order and epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "s2d_gemm.cuh"

namespace depgan {
namespace wg {

constexpr int kBM = 128;    // GEMM rows of a block with one m64 tile a consumer warpgroup
constexpr int kBK = 64;     // GEMM depth of one ring stage: 128 bytes of bf16
constexpr int kHalf = 32;   // depth of one A box: 64 bytes, the 64-byte swizzle
constexpr int kVec = 8;     // depth of one cp.async copy: 16 bytes
constexpr int kStages = 4;  // ring stages (48 KB each at BN = 256)
constexpr int kPast = -1;   // a plan entry past K: its copies are zeros

enum Route : int { kRouteTma = 0, kRouteCpAsync = 1 };

// One bf16 launch: K1 or K2 (gather kGatherConv3x3, n_ops 1), K3 (n_ops 2,
// relu), K7 (kGatherConv5x5, n_ops 1, relu or none), K9 (kGatherConv3x3,
// n_ops 1, epilogue kHead: no out, the head's tanh into head_out) or K4
// (kGatherDeconv, n_ops 1, relu, n = 2m the output's interior side).
struct Conv {
  const __nv_bfloat16* x[2];  // (batch, n+2, n+2, c4[o]) padded planes
  const __nv_bfloat16* w[2];  // (depth(gather, c4[o]), co4) weight rows
  int c4[2];
  int gather, n_ops, batch, n, co4, epilogue;  // the engine's Gather and Epilogue
  int pool;            // the engine's PoolMode; K2 only
  const float* bias;   // (co4,)
  const float* gamma;  // (batch, co4), film only
  const float* beta;   // (batch, co4), film only
  __nv_bfloat16* out;     // (batch, n+2, n+2, co4)
  __nv_bfloat16* pooled;  // pixel: (batch, n, n, co4/4); s2d: (batch, n/2+2, n/2+2, co4)
  const __nv_bfloat16* w_head;  // (co4, h4), K9 only
  const float* b_head;          // (h4,)
  float* head_out;              // (batch, n, n, h4): tanh(head), unpadded
  int h4;                       // head columns, 1 .. 16
};

struct Geometry {
  int route;     // kRouteTma or kRouteCpAsync
  int bm;        // rows of a block: 128, or 256 (two m64 tiles a consumer) for bn <= 128
  int bn;        // columns of a block: 64, 128, 192 or 256
  int n_blocks;  // column blocks
  int box[4];    // A box extents (32, bx, by, bb); zeros for cp.async
};

// GEMM depth of an operand with c4 channels: 4 taps or 9 taps of 4C.
__host__ __device__ inline int depth(int gather, int c4) {
  return (gather == kGatherConv5x5 ? 9 : 4) * c4;
}

// Whether every tile of bm rows is one box of the plane (n a multiple or a
// divisor of bm), every 32-deep half of every operand one chunk of one tap
// group (C channels for the 3x3 gather, 4C for the 5x5), and K a whole number
// of k-tiles (so no box reads past it: the 5x5's 9 * 4C needs 4C % 64 == 0).
__host__ __device__ inline bool boxes(int gather, int n, int bm, const int* c4, int n_ops) {
  bool ok = n % bm == 0 || bm % n == 0;
  for (int o = 0; o < n_ops; ++o)
    ok = ok && (gather == kGatherConv5x5 ? c4[o] % (2 * kHalf) == 0 : (c4[o] / 4) % kHalf == 0);
  return ok;
}

__host__ __device__ inline Geometry geometry(int gather, int n, const int* c4, int n_ops,
                                             int co4) {
  Geometry g{};
  g.n_blocks = (co4 + 255) / 256;
  g.bn = ((co4 + g.n_blocks - 1) / g.n_blocks + 63) / 64 * 64;
  g.bm = g.bn <= 128 && boxes(gather, n, 2 * kBM, c4, n_ops) ? 2 * kBM : kBM;
  g.route = boxes(gather, n, g.bm, c4, n_ops) ? kRouteTma : kRouteCpAsync;
  if (g.route == kRouteTma) {
    const int bx = n >= g.bm ? g.bm : n;
    const int by = n >= g.bm ? 1 : (n < g.bm / n ? n : g.bm / n);
    g.box[0] = kHalf, g.box[1] = bx, g.box[2] = by, g.box[3] = g.bm / (bx * by);
  }
  return g;
}

// Whether the mainloop takes a launch of these widths (the engine's Gather
// and PoolMode): whole 16-byte runs of one tap group (4C % 32 == 0 for the
// 3x3 gather, % 8 for the 5x5) whose channels fit the plan's 16 bits, one
// operand for the 5x5, and a pool only on one 3x3 operand at an even n for
// s2d and at a 4Co whose columns lie in one block (n_blocks 1) and reach,
// after the epilogue's transpose, each lane as the same channels of every
// group (4Co = BN = 128, 256) or of some groups, the quad holding the others
// (4Co = 32, 64 in a block of 64).
__host__ __device__ inline bool takes(int gather, int n, const int* c4, int n_ops, int co4,
                                      int pool) {
  const bool conv5 = gather == kGatherConv5x5;
  bool ok = (conv5 || gather == kGatherConv3x3) && n > 0 && co4 > 0 && co4 % 8 == 0 &&
            n_ops >= 1 && n_ops <= (conv5 ? 1 : 2);
  for (int o = 0; o < n_ops; ++o)
    ok = ok && c4[o] > 0 && c4[o] % (conv5 ? kVec : 4 * kVec) == 0 && c4[o] <= 0xFFFF;
  if (pool == kPoolNone) return ok;
  return ok && (pool == kPoolPixel || (pool == kPoolS2d && n % 2 == 0)) && !conv5 &&
         n_ops == 1 && (co4 == 32 || co4 == 64 || co4 == 128 || co4 == 256);
}

// What GEMM depth k0 of an operand with c4 channels reads: the plane's
// channel and the tap's offset (dx, dy) from the row's own position. A run
// of kHalf (TMA) or kVec (cp.async) depths from k0 stays inside one group.
struct Chunk {
  int c, dx, dy;
};
__host__ __device__ inline Chunk chunk(int gather, int c4, int k0) {
  if (gather == kGatherConv5x5) {
    const int tap = k0 / c4;
    return {k0 % c4, tap % 3, tap / 3};
  }
  const int c = c4 / 4, tap = k0 / c4, r = k0 % c4, dst = r / c;
  return {(3 - dst) * c + r % c, (tap & 1) + (dst & 1), (tap >> 1) + (dst >> 1)};
}

// The load plan's entry for the kVec-deep run at depth k0 of an operand:
// c | dx << 16 | dy << 20, or kPast at and past K.
__host__ __device__ inline int plan_entry(int gather, int c4, int k0) {
  if (k0 >= depth(gather, c4)) return kPast;
  const Chunk ck = chunk(gather, c4, k0);
  return ck.c | ck.dx << 16 | ck.dy << 20;
}

// The position (x, y, b) of GEMM row m: a tile's box origin for its first row.
struct Origin {
  int x, y, b;
};
__host__ __device__ inline Origin origin(int n, int64_t m) {
  const int64_t nn = (int64_t)n * n;
  const int rem = (int)(m % nn);
  return {rem % n, rem / n, (int)(m / nn)};
}

// Launches one problem; returns cudaGetLastError() after the launch, or an
// error code for what the mainloop does not take.
cudaError_t conv(const Conv& cv, cudaStream_t stream);

// P1: K1's relu conv (one 3x3 operand, no pool, 4Co of one 64- or 128-column
// block) as the probe phase `phase` (kProbeFull .. kProbeStageOnly), each
// tile's phase run `reps` times back to back. matmul_only reads a_dense,
// the (batch*n*n, 4*c4) gathered taps; stage_only writes sums, one float a
// tile of bm rows, and no output.
cudaError_t probe(const Conv& cv, int phase, const __nv_bfloat16* a_dense, float* sums, int reps,
                  cudaStream_t stream);

// P2's window. Work unit (b, s) of a launch with `units` units an image owns
// padded output rows [s (n+2)/units, (s+1) (n+2)/units), ring rows included:
// interior rows [ya, yb). Its rows_u = yb - ya output rows read the rows_u + 2
// padded input rows ya .. yb + 1, each loaded once by TMA into a ring of
// `slots` row slots. A slot holds one padded input row as c4/8 chunks of 8
// channels, each chunk `pitch` pixels of 16 bytes: [chunk][pixel][8], the
// non-swizzled K-major layout, so the 8-row core matrix of any 8 consecutive
// pixels is 128 contiguous bytes at a 16-byte-aligned start. A tile is `rows`
// output rows of wrow GEMM rows (n rounded up to 64, so no m64 tile spans two
// rows); its 16-deep step at depth k0 reads, for output row r and pixel x,
// slot row r + dy, pixel x + dx, channels c .. c + 15 of chunk() (two chunks,
// pitch * 16 bytes apart: the descriptor's leading offset; 8-pixel groups
// 128 bytes apart: its stride offset). A tile's rows past the unit read its
// last row and are not stored. B streams through a ring of b_stages stages
// as the mainloop's, as many as fit beside the window up to kStages (two at
// level 2, whose window takes 144 KB).
struct Window {
  int bm, bn, n_blocks;  // the tile: rows, columns, column blocks (bm 256 where bn <= 128)
  int wrow;              // GEMM rows an output row takes
  int rows;              // output rows a tile: bm / wrow
  int pitch;             // pixels of a slot's chunk: wrow + 2 rounded up to 8 (128-byte chunks)
  int slots;             // row slots: rows + 2
  int b_stages;          // B ring stages
  int smem;              // dynamic shared memory bytes, the 1 KB alignment included
};
constexpr int kSmemMax = 227 * 1024 - 256;  // dynamic shared memory beside a block's barriers

__host__ __device__ inline int slot_bytes(int c4, int pitch) { return c4 / 8 * pitch * 16; }

// The window of a P2 launch at interior side n; bm 0 where the mainloop
// refuses it: 4C a multiple of 64 (a 16-deep step is two chunks of one tap
// group), a padded row at most 256 pixels (one TMA box), every output row in
// one tile, and two B stages beside the window. The tile is K1's where its
// slots fit (bm 256 where bn <= 128), else 128 rows.
__host__ __device__ inline Window window(int n, int c4, int co4) {
  Window w{};
  if (n <= 0 || n + 2 > 256 || c4 <= 0 || c4 % 64 != 0 || c4 > 0xFFFF || co4 <= 0 || co4 % 8)
    return w;
  const Geometry g = geometry(kGatherConv3x3, n, &c4, 1, co4);  // K1's column blocks
  w.n_blocks = g.n_blocks;
  w.bn = g.bn;
  w.wrow = (n + 63) / 64 * 64;
  w.pitch = (w.wrow + 2 + 7) / 8 * 8;
  // bm 256 where bn <= 128 and its slots leave room for two B stages, else 128
  for (w.bm = w.bn <= 128 ? 2 * kBM : kBM; w.bm >= kBM; w.bm -= kBM) {
    w.rows = w.bm / w.wrow;
    w.slots = w.rows + 2;
    const int fixed = 1024 + w.slots * slot_bytes(c4, w.pitch) + c4 / 4 * 8;  // plan: 2 ints a step
    w.b_stages = (kSmemMax - fixed) / (w.bn * kBK * 2);
    if (w.b_stages > kStages) w.b_stages = kStages;
    w.smem = fixed + w.b_stages * w.bn * kBK * 2;
    if (w.rows >= 1 && w.b_stages >= 2) return w;
  }
  w.bm = 0;
  return w;
}

// Interior rows [ya, yb) of unit s of `units` an image.
__host__ __device__ inline void unit_rows(int n, int units, int s, int* ya, int* yb) {
  const int rb = (n + 2) / units;
  *ya = s * rb - 1 < 0 ? 0 : s * rb - 1;
  *yb = (s + 1) * rb - 1 > n ? n : (s + 1) * rb - 1;
}

// P2: K1's relu conv with the output cut into `units` row blocks an image
// (units divides n+2), each staging its input rows once.
cudaError_t rowblk(const Conv& cv, int units, cudaStream_t stream);

// K11's window (the kernel conv5_wgmma in wgmma_conv5.cu): K7's 5x5 gather on K1's
// tile walk, A read from the tile's input rows staged once. A tile is `rows`
// whole output rows of wrow GEMM rows (64, 128 or 256, the least that holds
// n: no m64 tile spans two rows, and the rows fill the tile): bm 256 where
// bn <= 128 (two rows at n 128, four at n 64), else 128. Its rows + 2 padded input rows arrive as one TMA box (8
// channels, n + 2 pixels, rows + 2 rows) for each 8-channel chunk: a window
// is [chunk][row][pixel][8], the non-swizzled K-major layout, chunks `lead`
// bytes apart, so the 16-deep step at depth k0 (tap = k0 / 4C, channels c ..
// c + 15 of two chunks) reads, for output row r and pixel x, window row r +
// tap / 3 at pixel x + tap % 3: one address, the two chunks a descriptor's
// leading offset apart and 8 pixels its 128-byte stride offset. 4C % 16 == 0
// keeps a step in one tap. Two windows where they fit beside two B stages,
// so the producer loads the next tile's rows while the consumers multiply.
// B (9 4C x 4Co, K7's rows) is loaded once a block and kept where all of it
// fits beside two windows (the critic's L0a, L0b and their transposes) or
// one (L1a: 144 KB), else it streams through its ring as the mainloop's. A
// window's last chunk is followed by a zero pad of (wrow - n) pixels, what
// the junk pixels past n of its last row read. Steps past K (4C 16: K 144
// of 3 k-tiles) are skipped; the others run in K7's order, so K11 equals K7
// bit for bit.
struct Conv5Window {
  int bm, bn, mt;  // tile rows and columns, m64 tiles a consumer warpgroup (bm / 128)
  int wrow;        // GEMM rows an output row takes: 64, 128 or 256, at least n
  int rows;        // output rows a tile: bm / wrow
  int pitch;       // pixels of a window row: n + 2
  int lead;        // bytes between a window's chunks: (rows + 2) pitch 16, rounded up to 128
  int win_bytes;   // a window: its chunks and the pad, rounded up to 1 KB
  int w_stages;    // windows: 2 where they fit beside 2 B stages, else 1
  int b_stages;    // B ring stages, up to kStages; kt where B is kept
  int resident;    // 1: all of B loaded once a block and kept, 0: B streamed
  int steps;       // 16-deep steps up to K: 9 4C / 16
  int kt;          // k-tiles of B: 9 4C / 64 rounded up
  int smem;        // dynamic shared memory bytes, the 1 KB alignment included
};
// K11's window at interior side n, 4C = c4, 4Co = co4; bm 0 where the
// kernel refuses it: 4C a multiple of 16, 4Co of 8 and at most 256 (one
// column block), n + 2 at most 256 (a row is one TMA box), and two B
// stages beside one window. B is kept where all of it fits beside one
// window, else streamed.
__host__ __device__ inline Conv5Window conv5_window(int n, int c4, int co4) {
  Conv5Window w{};
  if (n <= 0 || n + 2 > 256 || c4 <= 0 || c4 % 16 != 0 || c4 > 0xFFFF || co4 <= 0 ||
      co4 % 8 != 0 || co4 > 256)
    return w;
  w.bn = (co4 + 63) / 64 * 64;
  w.bm = w.bn <= 128 ? 2 * kBM : kBM;
  w.mt = w.bm / kBM;
  for (w.wrow = 64; w.wrow < n;) w.wrow *= 2;
  w.rows = w.bm / w.wrow;
  w.pitch = n + 2;
  w.lead = ((w.rows + 2) * w.pitch * 16 + 127) / 128 * 128;
  w.win_bytes = (c4 / 8 * w.lead + (w.wrow - n) * 16 + 1023) / 1024 * 1024;
  w.steps = 9 * c4 / 16;
  w.kt = (9 * c4 + kBK - 1) / kBK;
  const int b_stage = w.bn * kBK * 2, fixed = 1024 + w.steps * 4;
  const int b_all = w.kt * b_stage;  // B kept: two windows where they fit beside it, else one
  w.resident = fixed + w.win_bytes + b_all <= kSmemMax;
  w.w_stages = fixed + 2 * w.win_bytes + (w.resident ? b_all : 2 * b_stage) <= kSmemMax ? 2 : 1;
  w.b_stages = (kSmemMax - fixed - w.w_stages * w.win_bytes) / b_stage;
  if (w.b_stages > (w.resident ? w.kt : kStages)) w.b_stages = w.resident ? w.kt : kStages;
  w.smem = fixed + w.w_stages * w.win_bytes + w.b_stages * b_stage;
  if (w.rows < 1 || w.b_stages < 2) w.bm = 0;
  return w;
}

// K11: K7's function (Conv with gather kGatherConv5x5, one operand, relu or
// none) over the window.
cudaError_t conv5_window_conv(const Conv& cv, cudaStream_t stream);

// K4 (deconv_wgmma in wgmma_deconv.cu): the 2x2 stride-2 transposed conv
// from the padded plane (B, m+2, m+2, 4C) into (B, 2m+2, 2m+2, 4O),
//   out[b, 2i+p+1, 2j+q+1, :] = relu(x[b, i+1, j+1, (2p+q)C : (2p+q+1)C] @ w2 + b4),
// a GEMM K = C deep whose rows are output positions. A tile is one input row
// i of image b and one column block: its two output rows 2i + p (p = 0, 1),
// each wrow GEMM rows x = 2j + q (2m rounded up to 64: no m64 tile spans two
// output rows; rows past 2m are junk and not stored). Consumer warpgroup g
// takes output row p = g, its m64 tiles one after another. Viewed as the
// 5-d tensor (C, 2 [q], 2 [p], m+2 [j], B(m+2) [b, i]), which is the plane
// itself (strides 2, 2C, 4C, 8C and (m+2) 8C bytes), the input gives a row's
// A as one TMA box a 32-deep half: extents (32, 2, 1, m, 1) at (32 h, 0, p,
// 1, b(m+2) + i + 1) land as [j][q][32 channels], GEMM row 2j + q, K-major
// in the mainloop's 64-byte-swizzled halves (zeros past C, where C < 32).
// B (C x 4O, every column block) is loaded once a block by TMA in the
// mainloop's 64 x 64 boxes and kept. Each m64 tile's bf16 output is staged
// in shared memory (128-byte swizzled 64 x 64 boxes) and sent by TMA stores,
// the next tile's products and epilogue running while they drain.
struct DeconvPlan {
  int bn, n_blocks;  // column blocks of 4O, as geometry(): bn up to 256
  int wrow;          // GEMM rows an output row takes: 2m rounded up to 64
  int steps;         // 16-deep steps: C / 16 rounded up
  int halves;        // 32-deep A boxes an output row: C / 32 rounded up
  int kt;            // 64-deep k-tiles of B: C / 64 rounded up
  int a_row;         // bytes of an output row's A: halves x wrow rows x 64
  int a_stages;      // A tiles (two output rows each): 2 where they fit, else 1
  int b_bytes;       // all of B, kept: n_blocks x kt x bn x 128
  int bufs;          // output staging buffers a consumer (64 x bn bf16 each): 2 or 1
  int smem;          // dynamic shared memory bytes, the 1 KB alignment included
};

// K4's plan for input side m, 4C = c4, 4O = o4; bn 0 where the kernel
// refuses it: C a multiple of 8 (16-byte TMA strides), m at most 256 (a
// box extent), 4O a multiple of 8, and all of B with one A tile and one
// staging buffer a consumer inside the shared memory.
__host__ __device__ inline DeconvPlan deconv_plan(int m, int c4, int o4) {
  DeconvPlan p{};
  if (m <= 0 || m > 256 || c4 <= 0 || c4 % (4 * kVec) != 0 || c4 > 0xFFFF || o4 <= 0 || o4 % 8)
    return p;
  const int c = c4 / 4;
  p.n_blocks = (o4 + 255) / 256;
  p.bn = ((o4 + p.n_blocks - 1) / p.n_blocks + 63) / 64 * 64;
  p.wrow = (2 * m + 63) / 64 * 64;
  p.steps = (c + 15) / 16;
  p.halves = (c + kHalf - 1) / kHalf;
  p.kt = (c + kBK - 1) / kBK;
  p.a_row = p.halves * p.wrow * 64;
  p.b_bytes = p.n_blocks * p.kt * p.bn * kBK * 2;
  for (p.bufs = 2; p.bufs >= 1; --p.bufs)
    for (p.a_stages = 2; p.a_stages >= 1; --p.a_stages) {
      p.smem = 1024 + p.a_stages * 2 * p.a_row + p.b_bytes + 2 * p.bufs * 64 * p.bn * 2;
      if (p.smem <= kSmemMax) return p;
    }
  p = DeconvPlan{};
  return p;
}

// K4: the Conv with gather kGatherDeconv (x, w2 (C, 4O), bias, out; n = 2m);
// an error code for what deconv_plan refuses.
cudaError_t deconv(const Conv& cv, cudaStream_t stream);

// K10 (chain_wgmma in wgmma_chain.cu): a whole generator site, conv_in (K1,
// or K3's two operands) -> the FiLM conv (K1 film) -> conv_out (K1, or K2
// with its pool), in one launch. A persistent block owns a T x T tile of
// output positions of one image. Region 0 holds stage 0's output over
// (T + 4)^2 positions, region 1 stage 1's over T + 2 rows at region 0's
// pitch T + 4; both in shared memory in the non-swizzled K-major layout
// [chunk][pixel][8], the pixels of a region flattened row by row, chunks
// `lead` bytes apart. A stage computes over its rows x pitch flattened
// into GEMM rows, in passes of 128 mt rows (whole region rows a pass), and
// stage s + 1 reads region s at + dy pitch + dx pixels: a tap's shift is a
// descriptor address. Positions on the padded plane's ring or outside it,
// and the columns past a stage's side, are stored as zeros. Stage 0 reads
// the planes by K1's A routes, TMA boxes (32 channels, pitch, prow rows) or
// cp.async where C % 32 != 0, into a ring whose A halves start at region 1,
// which is not written yet (and run past it where the ring is the larger:
// level 1's three 32 KB stages); each stage's B streams through the one ring.
// Each stage sums its k-tiles in order with BN = 4Cm, the sequential
// kernel's instruction, and rounds to bf16 where the sequential kernels
// store, so K10 equals K1/K3 -> K1 film -> K1/K2 bit for bit.
struct ChainPlan {
  int route;     // stage 0's A: kRouteTma or kRouteCpAsync
  int bn, mt;    // columns (4Cm), m64 tiles a consumer warpgroup: a pass is 128 mt GEMM rows
  int tile;      // T
  int pitch;     // pixels of a region row: T + 4
  int prow[3];   // region rows a pass, by stage
  int passes[3]; // passes, by stage
  int rpx;       // pixels a region chunk holds: the live ones and what junk rows read past them
  int lead;      // bytes between a region's chunks: rpx 16
  int region;    // bytes of a region, rounded up to 1 KB
  int area1;     // bytes from region 1 to the B ring: the region, or the A ring where larger
  int stages;    // ring stages: A halves from region 1 on, B in its own area
  int smem;      // dynamic shared memory bytes, the 1 KB alignment included
};

// The rows of stage s's region: T + 4, T + 2, T.
__host__ __device__ inline int chain_rows(int tile, int s) { return tile + 4 - 2 * s; }

// The plan of a K10 launch at interior side n with stage-0 widths c4 (n_ops
// of them), 4Cm = c4m and 4Co = c4o; bn 0 where the kernel refuses it:
// 4Cm 128 or 256 with 4Co = 4Cm (BN = 4Cm, the sequential kernels' width),
// stage-0 widths of whole 16-byte runs of one channel group (C % 8 == 0),
// pool s2d at an even n. T is the side, from 2 to 32, that fits with two
// ring stages and computes the fewest GEMM rows an image (tail tiles
// included): 12 at 4Cm 128 and n 128, 8 at 4Cm 256 and n 64.
__host__ __device__ inline ChainPlan chain_plan(int n, const int* c4, int n_ops, int c4m, int c4o,
                                               int pool) {
  ChainPlan p{};
  bool ok = n > 0 && n_ops >= 1 && n_ops <= 2 && (c4m == 128 || c4m == 256) && c4o == c4m &&
            pool >= kPoolNone && pool <= kPoolS2d && (pool != kPoolS2d || n % 2 == 0);
  bool boxes = true;
  for (int o = 0; o < n_ops; ++o) {
    ok = ok && c4[o] > 0 && c4[o] % (4 * kVec) == 0 && c4[o] <= 0xFFFF;
    boxes = boxes && (c4[o] / 4) % kHalf == 0;
  }
  if (!ok) return p;
  const int bn = c4m, mt = bn <= 128 ? 2 : 1, bmp = kBM * mt;
  const int b_stage = bn * kBK * 2, a_stage = bmp * kBK * 2;
  int kt0 = 0;
  for (int o = 0; o < n_ops; ++o) kt0 += 4 * c4[o] / kBK;
  const int fixed = 1024 + kt0 * (kBK / kVec) * 4 + c4m / 4 * 4;  // the two plans
  int64_t best = 0;  // GEMM rows an image of the plan so far
  for (int t = 2; t <= 32; ++t) {
    ChainPlan q{};
    q.route = boxes ? kRouteTma : kRouteCpAsync;
    q.bn = bn, q.mt = mt, q.tile = t, q.pitch = t + 4;
    if (q.pitch > bmp) break;
    int rows = 0;
    q.rpx = q.pitch * chain_rows(t, 0);
    for (int s = 0; s < 3; ++s) {
      const int r = chain_rows(t, s);
      q.prow[s] = bmp / q.pitch < r ? bmp / q.pitch : r;
      q.passes[s] = (r + q.prow[s] - 1) / q.prow[s];
      rows += q.passes[s] * bmp;
      // stage s reads region s - 1 up to its last pass's rows + 2 pitch + 2
      const int reach = (q.passes[s] - 1) * q.prow[s] * q.pitch + bmp + 2 * q.pitch + 2;
      if (s > 0 && reach > q.rpx) q.rpx = reach;
    }
    q.lead = q.rpx * 16;
    q.region = (c4m / 8 * q.lead + 1023) / 1024 * 1024;
    // The most ring stages that fit, the A ring running past region 1 where
    // it is the larger: 3 at level 1 (32 KB A stages), 2 at level 2 (32 KB B).
    for (q.stages = kStages; q.stages >= 2; --q.stages) {
      q.area1 = q.region > q.stages * a_stage ? q.region : q.stages * a_stage;
      q.smem = fixed + q.region + q.area1 + q.stages * b_stage;
      if (q.smem <= kSmemMax) break;
    }
    const int64_t side = (n + t - 1) / t, per_image = side * side * rows;
    if (q.stages >= 2 && (p.bn == 0 || per_image < best)) p = q, best = per_image;
  }
  return p;
}

// One bf16 K10 launch: stage 0 over x[0..n_ops) with w0 (4 c4[o], c4m),
// relu; stage 1 the film conv w1 (4 c4m, c4m) with gamma, beta (batch,
// c4m) and the trunk from region 0; stage 2 the relu conv w2 (4 c4m, c4m)
// into out, with its pool when pool != kPoolNone.
struct Chain {
  const __nv_bfloat16* x[2];
  const __nv_bfloat16* w0[2];
  int c4[2];
  int n_ops;
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  const float* bias[3];
  const float* gamma;
  const float* beta;
  int batch, n, c4m, pool;
  __nv_bfloat16* out;     // (batch, n+2, n+2, c4m)
  __nv_bfloat16* pooled;  // pixel: (batch, n, n, c4m/4); s2d: (batch, n/2+2, n/2+2, c4m)
};

// K10 on the wgmma machinery; an error code for what chain_plan refuses.
cudaError_t chain3(const Chain& ch, cudaStream_t stream);

}  // namespace wg
}  // namespace depgan
