// The bf16 wgmma mainloop of K1 (conv3x3_s2d_fused: relu, film, none; no
// pool) and K3 (conv3x3_s2d_fused2) for Hopper (sm_90a): what the host and
// the kernel share. The kernel is in wgmma_kernels.cu.
//
// The GEMM is the engine's (s2d_gemm.cuh, kGatherConv3x3): rows m = (b, y, x)
// are output positions, k = (tap, dst, c) over 4 taps x 4C of each operand,
// operand 1's k range after operand 0's, and row m at depth k reads
// x[b, y+dy, x+dx, (3-dst)*C + c] of the padded plane with
// dy = (tap>>1) + (dst>>1), dx = (tap&1) + (dst&1).
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
// 64-byte-swizzled K-major layout. With C a multiple of 32 a half is one
// (tap, dst) group's channel chunk, and the BM rows of a tile read a box of
// the plane (B, P, P, 4C) viewed as a 4-d tensor (4C, P, P, B):
//   extents (32, bx, by, bb), origin (c, x0 + dx, y0 + dy, b0)
// with (x0, y0, b0) the tile's first position: one image row of 128 at
// n = 128 and BM = 128, two rows of 128 or 64 at n = 128 or 64 with BM 256
// or 128, several images when n*n < BM. Such a launch loads A by TMA (route
// kRouteTma). Otherwise (C = 8, the first level-1 conv, or n neither a
// multiple nor a divisor of 128) the producer warpgroup gathers A, 128 rows
// a tile, in 16-byte cp.async copies into the same layout (route
// kRouteCpAsync). B, the weight rows (k, 4Co), arrives by TMA in
// 64 x 64 boxes, 128-byte swizzled, N-major. The route is fixed at launch by
// geometry(); ops/wgmma_plan.py is its mirror in Python, which the CPU tests
// check against the plain gather and chip_smoke.py against this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace depgan {
namespace wg {

constexpr int kBM = 128;    // GEMM rows of a block with one m64 tile a consumer warpgroup
constexpr int kBK = 64;     // GEMM depth of one ring stage: 128 bytes of bf16
constexpr int kHalf = 32;   // depth of one A box: 64 bytes, the 64-byte swizzle
constexpr int kVec = 8;     // depth of one cp.async copy: 16 bytes
constexpr int kStages = 4;  // ring stages (48 KB each at BN = 256)

enum Route : int { kRouteTma = 0, kRouteCpAsync = 1 };

// One bf16 launch of K1 (n_ops 1) or K3 (n_ops 2, relu) without a pool.
struct Conv {
  const __nv_bfloat16* x[2];  // (batch, n+2, n+2, c4[o]) padded planes
  const __nv_bfloat16* w[2];  // (4 * c4[o], co4) weight rows
  int c4[2];
  int n_ops, batch, n, co4, epilogue;  // epilogue: the engine's kRelu, kFilm, kNone
  const float* bias;   // (co4,)
  const float* gamma;  // (batch, co4), film only
  const float* beta;   // (batch, co4), film only
  __nv_bfloat16* out;  // (batch, n+2, n+2, co4)
};

struct Geometry {
  int route;     // kRouteTma or kRouteCpAsync
  int bm;        // rows of a block: 128, or 256 (two m64 tiles a consumer) for bn <= 128
  int bn;        // columns of a block: 64, 128, 192 or 256
  int n_blocks;  // column blocks
  int box[4];    // A box extents (32, bx, by, bb); zeros for cp.async
};

// Whether every tile of bm rows is one box of the plane (n a multiple or a
// divisor of bm) and every operand's C whole kHalf-deep chunks.
__host__ __device__ inline bool boxes(int n, int bm, const int* c4, int n_ops) {
  bool ok = n % bm == 0 || bm % n == 0;
  for (int o = 0; o < n_ops; ++o) ok = ok && (c4[o] / 4) % kHalf == 0;
  return ok;
}

__host__ __device__ inline Geometry geometry(int n, const int* c4, int n_ops, int co4) {
  Geometry g{};
  g.n_blocks = (co4 + 255) / 256;
  g.bn = ((co4 + g.n_blocks - 1) / g.n_blocks + 63) / 64 * 64;
  g.bm = g.bn <= 128 && boxes(n, 2 * kBM, c4, n_ops) ? 2 * kBM : kBM;
  g.route = boxes(n, g.bm, c4, n_ops) ? kRouteTma : kRouteCpAsync;
  if (g.route == kRouteTma) {
    const int bx = n >= g.bm ? g.bm : n;
    const int by = n >= g.bm ? 1 : (n < g.bm / n ? n : g.bm / n);
    g.box[0] = kHalf, g.box[1] = bx, g.box[2] = by, g.box[3] = g.bm / (bx * by);
  }
  return g;
}

// What GEMM depth k0 of an operand with c4 channels reads: the plane's
// channel and the tap's offset (dx, dy) from the row's own position. A run
// of kHalf (TMA) or kVec (cp.async) depths from k0 stays inside one group.
struct Chunk {
  int c, dx, dy;
};
__host__ __device__ inline Chunk chunk(int c4, int k0) {
  const int c = c4 / 4, tap = k0 / c4, r = k0 % c4, dst = r / c;
  return {(3 - dst) * c + r % c, (tap & 1) + (dst & 1), (tap >> 1) + (dst >> 1)};
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
cudaError_t conv3x3(const Conv& cv, cudaStream_t stream);

}  // namespace wg
}  // namespace depgan
