// The bf16 wgmma mainloop of K1, K2, K3, K7 and K9 for Hopper (sm_90a); the
// design is in s2d_wgmma.cuh.
//
// Replaces, beside the engine's CUDA-core float32 path (s2d_kernels.cu), the
// bf16 launches of the Pallas kernels of depgan_tpu/ops/conv_s2d_pallas.py:
//  - conv3x3_s2d_fused (:758, kernel _kernel :490) with the epilogue relu,
//    film or none and no pool: on the serving path at n = 128 (4C 32 or 128
//    -> 128) and n = 64 (128 or 256 -> 256); the backward's transposes add
//    128 -> 256, 256 -> 128 and 256 -> 384.
//  - conv3x3_s2d_fused_pool (:1043, kernel _kernel_pool :1022): the relu conv
//    that also writes the 2x2 max-pool of its stored output, as the next
//    level's padded s2d plane (L1: n = 128, 128 -> 128) or in pixels (L2:
//    n = 64, 256 -> 256).
//  - conv3x3_s2d_fused2 (:1289, kernel _kernel2 :1217): the two operands are
//    two k ranges of one accumulator; p2 at n = 64 (384 + 256 -> 256) and p1
//    at n = 128 (256 + 128 -> 128), K = 2560 and 1536.
//  - conv5x5_s2d_fused (:1918 -> _conv5_impl :1940, kernel _kernel5 :1863):
//    the critic's SAME 5x5 convs as 9 dense taps, relu or none; n = 128
//    (4C 16 or 64 -> 64) and n = 64 (64 or 128 -> 128), and the transposes
//    64 -> 16, 64 -> 64, 128 -> 64 and 128 -> 128: K = 144 to 1152.
//  - conv3x3_s2d_fused_head (:1145, kernel _kernel mode 'head' :589-606):
//    p1's conv_out with the generator's 1x1 head in its epilogue, the
//    serving forward's last conv under fuse_head (n = 128, 128 -> 128,
//    h4 = 4): tanh(bf16(relu(y + b)) @ bf16(W_head) + b_head), summed in
//    float32, written unpadded (batch, n, n, h4) in float32. Its bound is
//    the bytes (at batch 42: 176 MB of input plane, 11 MB of head output,
//    0.056 ms; the s2d GEMM's own products take 0.092 ms at the bf16 peak),
//    and it never stores the 176 MB relu plane that K1 writes. The engine
//    ran it at 0.71 ms: its wmma mainloop, then a block-wide barrier and a
//    4Co-long serial fmaf loop per (row, head column) from shared memory.
//    Here it is the HEAD instantiation of the mainloop: K1's relu tile and
//    ring, the head summed from registers in the engine's order, each lane
//    of a row's quad running one head column's chain over the row's values
//    shuffled to it in column order (head_epilogue), no barrier.
// and, of the JAX package's probe scripts, in bf16:
//  - P1, run_variant (scripts/kernel_anatomy.py:108; k_full :80,
//    k_matmul_only :90, k_stage_only :97): K1's relu launch split into
//    phases, the kernel's PHASE argument, each repeated reps times a tile,
//    so that (t(5) - t(1)) / 4 is a rep's marginal cost with its boxes fed
//    from L2 (a whole walk's repeat would come from HBM: the level-1 plane at
//    batch 64 is ~277 MB). Its no_epi - full marginal is the epilogue's cost,
//    matmul_only - full the gathered boxes' against a dense A.
//  - P2, conv3x3_rowblk (scripts/rowblk_probe.py:125, kernel
//    _kernel_rowblk :54): K1's relu conv over work units of (n+2)/units
//    padded rows, each input row loaded once a unit into a window of row
//    slots (rowblk_wgmma). K1's tile re-reads each input row from L2 for
//    the taps of every tile that touches it (~4x at level 1); the window
//    reads it once a unit. Its A operand is read from the window through
//    a non-swizzled descriptor, so a tap's pixel shift is an address.
//
// Bound: the 3x3 GEMMs do ~300 FLOP per byte of their planes, at the H100's
// bf16 ridge, so the products' rate bounds them; the 5x5 GEMMs do 40-140,
// under it, so their planes' traffic does. The engine's wmma (mma.sync) with
// a block-wide barrier every 32 deep ran the first at ~18% of the bf16 peak
// and kept neither the loads nor the products busy. Here the products are
// wgmma, which alone reaches the tensor cores' full rate, and the loads run
// ahead of them through a ring of 4 stages 64 deep with no block-wide
// barrier: a producer warpgroup (TMA, or cp.async where the gather is not a
// box) and two consumer warpgroups that hold their BM/2 x BN float32
// accumulators in registers (setmaxnreg: 224 a consumer thread, 56 a
// producer thread). The producer reads each k run's (channel, dx, dy) from a
// plan the block computes once into shared memory, so its loop does no
// division. The grid is persistent, one block an SM walking over tiles, so
// the producer loads the next tile's k-tiles while the consumers store this
// one. The epilogue reads the accumulators from registers: a 4 x 4 transpose
// inside each quad of lanes gives every lane 8 consecutive columns of one
// row, so bias, relu or the FiLM site (x + relu(y * gamma + beta)), one
// rounding to bf16 and the store take 16-byte accesses. K2's pool follows in
// registers: with BN = 4Co, a lane's runs of 8 columns over the column loop
// are the same 8 channels of each of the four channel groups, so the max of
// the rounded values needs no other lane, and each lane stores its pooled
// runs in 16-byte stores. The block also writes its share of the zero rings.
// Each output sums its k-products in 16-deep wgmma steps in k order, the
// order of the engine's wmma steps, and equals the engine's output bit for
// bit (a K padded to whole k-tiles adds products of zeros); so do P1's full
// and matmul_only and P2, which sum in the same order.

#include "wgmma_device.cuh"

namespace depgan {
namespace wg {
namespace {

struct alignas(64) Params {
  CUtensorMap a_map[2];  // the planes as (4C, P, P, B), box (32, bx, by, bb); TMA route only.
                         // P1 matmul_only: a_map[0], the dense taps as (16C, M), box (32, bm)
  CUtensorMap b_map[2];  // the weights as (co4, k), box (64, 64)
  Conv conv;
  Geometry geo;
  int kt0, kt_total;     // k-tiles of operand 0, of both
  int reps;              // P1: repeats of each tile's phase
  float* sums;           // P1 stage_only: one float a tile of bm rows
};

// K9's head (HEAD): tanh(bf16(relu(y + b)) @ W_head + b_head) of each row,
// in the engine's order: the relu output rounded to bf16, then for each
// head column h one fmaf chain over the columns c = 0 .. 4Co - 1 in order.
// A quad of lanes holds a row (wgmma: lane q has columns 8j + 2q, + 1), so
// lane q runs the chain of head column h0 + q: y is rounded in place in the
// accumulators, and column c comes from lane (c / 2) % 4 by one shuffle to
// the quad, in order; each lane adds it to its own chain with full lanes,
// for the thread's 2 MT row sets side by side, so their chains overlap.
// Head columns go 4 at a time (h4 <= 16). wh is W_head as float in shared
// memory, [c][q][h0 / 4]: lane q's weight of column c at 16 c + 4 q + h0 / 4,
// zeros past 4Co, where the accumulators hold zeros too (B's columns past
// 4Co read as zeros): every chain runs BN steps, a trip count the compiler
// unrolls, so the accumulators stay in registers, and a step past 4Co adds
// an exact zero.
template <int BN, int MT>
__device__ __forceinline__ void head_epilogue(const Conv& cv, float (&acc)[MT][BN / 2],
                                              const float* wh, int64_t m0, int g, int warp,
                                              int lane, int q, int64_t M) {
  const int co4 = cv.co4, h4 = cv.h4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {  // y = bf16(relu(acc + b)) of the lane's own columns
    const int col = 8 * j + 2 * q;
    if (col >= co4) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(cv.bias + col));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& y0 = acc[mt][4 * j + 2 * i];
        float& y1 = acc[mt][4 * j + 2 * i + 1];
        y0 = __bfloat162float(__float2bfloat16(fmaxf(y0 + b.x, 0.f)));
        y1 = __bfloat162float(__float2bfloat16(fmaxf(y1 + b.y, 0.f)));
      }
  }
  for (int h0 = 0; h0 < h4; h0 += 4) {
    float part[2 * MT];
#pragma unroll
    for (int rs = 0; rs < 2 * MT; ++rs) part[rs] = 0.f;
#pragma unroll
    for (int c = 0; c < BN; ++c) {
      const float w = wh[16 * c + 4 * q + h0 / 4];
      const int from = (lane & ~3) | ((c >> 1) & 3);
#pragma unroll
      for (int rs = 0; rs < 2 * MT; ++rs)
        part[rs] = fmaf(__shfl_sync(0xffffffffu, acc[rs / 2][4 * (c >> 3) + 2 * (rs % 2) + (c & 1)],
                                    from),
                        w, part[rs]);
    }
    const int h = h0 + q;  // lane q's chain: head column h0 + q of its quad's row
    if (h >= h4) continue;
#pragma unroll
    for (int rs = 0; rs < 2 * MT; ++rs) {
      const int64_t m = m0 + (g * MT + rs / 2) * 64 + warp * 16 + (lane >> 2) + 8 * (rs % 2);
      if (m < M) cv.head_out[m * h4 + h] = tanhf(part[rs] + cv.b_head[h]);
    }
  }
}

// MT m64 tiles a consumer warpgroup: BM = 128 MT rows a block. POOL: K2's
// pooled epilogue, a separate instantiation so the others keep theirs lean.
// PHASE: kProduction, or a P1 probe phase (s2d_gemm.cuh's Phase), each
// compiled away from the others: full (K1's relu launch), no_epi (no bias,
// the launch's epilogue kNone), matmul_only (A by 2-d boxes of the dense
// taps), stage_only (the A loads alone, summed). A probe tile runs its phase
// p.reps times back to back; a rep re-reads its tile's A and B boxes, which
// the first rep brought into L2. HEAD: K9's head in place of the store
// (head_epilogue), an instantiation of its own as the pool is.
template <int BN, int MT, bool POOL, int PHASE = kProduction, bool HEAD = false>
__global__ void __launch_bounds__(kThreadsWg, 1) s2d_wgmma(const __grid_constant__ Params p) {
  static_assert(!POOL || BN == 64 || BN == 128 || BN == 256, "the pool takes BN = 64, 128, 256");
  static_assert(PHASE == kProduction || !POOL, "the probes run K1's unpooled launch");
  static_assert(!HEAD || (PHASE == kProduction && !POOL), "the head is K1's relu launch's");
  constexpr bool kStage = PHASE == kProbeStageOnly;
  constexpr int kBMt = kBM * MT, kA = MT * kABytes, kAHalf = MT * kAHalfBytes;
  constexpr int kStageBytes = kA + BN * kBK * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const Conv& cv = p.conv;
  const int tid = threadIdx.x, n = cv.n, side = n + 2, co4 = cv.co4;
  const bool tma = PHASE == kProbeMatmulOnly || p.geo.route == kRouteTma;
  const int reps = PHASE == kProduction ? 1 : p.reps;
  // The load plan, once a block: (channel, dx, dy) of every kVec-deep run of
  // the GEMM depth, operand 0's then operand 1's (plan_entry; kPast where a
  // k-tile runs past the operand's K).
  int* plan = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  const int runs0 = p.kt0 * (kBK / kVec), runs = p.kt_total * (kBK / kVec);
  for (int j = tid; j < runs; j += kThreadsWg) {
    const int op = j < runs0 ? 0 : 1;
    plan[j] = plan_entry(cv.gather, cv.c4[op], (j - (op ? runs0 : 0)) * kVec);
  }
  if constexpr (HEAD) {  // K9: W_head as float after the plan, [c][q][k] for column 4k + q
    float* wh = reinterpret_cast<float*>(plan + runs);
    for (int j = tid; j < BN * 16; j += kThreadsWg) {
      const int c = j / 16, h = 4 * (j & 3) + ((j >> 2) & 3);
      wh[j] = c < co4 && h < cv.h4 ? __bfloat162float(cv.w_head[c * cv.h4 + h]) : 0.f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], tma ? 1 : 1 + 128);  // expect_tx, and each cp.async producer thread
      mbar_init(&empty[s], 8);                 // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int64_t ring0 = (int64_t)blockIdx.x * kThreadsWg + tid;
  const int64_t ring_step = (int64_t)gridDim.x * kThreadsWg;
  if constexpr (!kStage && !HEAD) zero_ring(cv.out, cv.batch, side, co4, ring0, ring_step);
  if (POOL && cv.pool == kPoolS2d)
    zero_ring(cv.pooled, cv.batch, n / 2 + 2, co4, ring0, ring_step);
  __syncthreads();

  // Persistent: block i takes tiles i, i + grid, ... (column block fastest),
  // and the ring's k-tile count `it` runs on across them, so the producer
  // loads the next tile while the consumers store this one.
  const int64_t M = (int64_t)cv.batch * n * n;
  const int64_t tiles = (M + kBMt - 1) / kBMt * p.geo.n_blocks;

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tma) {  // one thread issues every box
      if (tid != 0) return;
      int it = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (int)(tile % p.geo.n_blocks) * BN;
        const int64_t m0 = tile / p.geo.n_blocks * kBMt;
        const Origin o = origin(n, m0);
        for (int rep = 0; rep < reps; ++rep)
        for (int t = 0; t < p.kt_total; ++t, ++it) {
          const int s = it % kStages, op = t < p.kt0 ? 0 : 1;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* a = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStage ? kA : kStageBytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (PHASE == kProbeMatmulOnly) {  // rows m0.., depths of the dense taps
              tma_2d(a + h * kAHalf, &p.a_map[0], &full[s], t * kBK + h * kHalf, (int)m0);
            } else {
              const int e = plan[t * (kBK / kVec) + h * (kHalf / kVec)];
              tma_4d(a + h * kAHalf, &p.a_map[op], &full[s], e & 0xFFFF,
                     o.x + ((e >> 16) & 15), o.y + (e >> 20), o.b);
            }
          }
          if constexpr (kStage) continue;
          const int k0 = (t - (op ? p.kt0 : 0)) * kBK;
#pragma unroll
          for (int j = 0; j < BN / kBBox; ++j)
            tma_2d(a + kA + j * kBBoxBytes, &p.b_map[op], &full[s], n0 + j * kBBox, k0);
        }
      }
      return;
    }
    if constexpr (MT == 1) {  // geometry() gives BM = 256 only with TMA boxes
      // cp.async: thread tid copies 16-byte run kv of each k-tile for rows
      // tid/8 + 16i, in the 64-byte swizzle (chunk j of row r at 16 (j ^ (r/2 % 4))).
      const int kv = tid & 7, r0 = tid >> 3;
      const uint32_t a_off = (kv >> 2) * kAHalf + r0 * 64 + (((kv & 3) ^ ((r0 >> 1) & 3)) << 4);
      int it = 0, pending = -1;  // the stage whose copies are not yet announced
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (int)(tile % p.geo.n_blocks) * BN;
        const int64_t m0 = tile / p.geo.n_blocks * kBM;
        int pix[8];  // the rows' positions as padded-plane pixels; -1 past M
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int64_t m = m0 + r0 + 16 * i;
          const Origin om = origin(n, m);
          pix[i] = m < M ? (om.b * side + om.y) * side + om.x : -1;
        }
        for (int rep = 0; rep < reps; ++rep)
        for (int t = 0; t < p.kt_total; ++t, ++it) {
          const int s = it % kStages, op = t < p.kt0 ? 0 : 1;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* a = smem + s * kStageBytes;
          if (tid == 0) {
            const int k0 = (t - (op ? p.kt0 : 0)) * kBK;
            mbar_expect_tx(&full[s], kStage ? 0 : BN * kBK * 2);  // stage_only: no B
#pragma unroll
            for (int j = 0; j < (kStage ? 0 : BN / kBBox); ++j)
              tma_2d(a + kA + j * kBBoxBytes, &p.b_map[op], &full[s], n0 + j * kBBox, k0);
          }
          const int c4 = cv.c4[op], e = plan[t * (kBK / kVec) + kv];
          const bool live = e != kPast;  // past K: zeros, as B's box reads past its rows
          const __nv_bfloat16* x = cv.x[op];
          const __nv_bfloat16* src =
              live ? x + ((e >> 20) * side + ((e >> 16) & 15)) * c4 + (e & 0xFFFF) : x;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool ok = live && pix[i] >= 0;
            cp_async16(a + a_off + i * 1024, ok ? src + (int64_t)pix[i] * c4 : x, ok);
          }
          cp_async_commit();
          if (pending >= 0) {  // the previous k-tile's copies: landed, fenced, announced
            cp_async_wait<1>();
            fence_proxy_async();
            mbar_arrive(&full[pending]);
          }
          pending = s;
        }
      }
      if (pending >= 0) {
        cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(&full[pending]);
      }
    }
    return;
  }

  // The consumer warpgroups: rows 64 MT g .. 64 MT (g + 1) - 1 of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31, q = lane & 3;
  // K2 (one column block, cp = 4Co / 4 channels a group): the lane's run of
  // columns 32G + 8q .. + 7 is channels (32G + 8q) % cp of group
  // (32G + 8q) / cp. At 4Co = BN = 128 or 256 (cp 32, 64) that is channels
  // 32 (G % kSlots) + 8q of group G / kSlots: each lane pools whole runs
  // alone. At BN = 64 (4Co 32 or 64, cp 8 or 16) every G gives the lane
  // channels 8q % cp, and the lanes of its quad hold the other groups.
  constexpr int kSlots = BN == 256 ? 2 : 1;
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (int)(tile % p.geo.n_blocks) * BN;
    const int64_t m0 = tile / p.geo.n_blocks * kBMt;
    for (int rep = 0; rep < reps; ++rep) {
    if constexpr (kStage) {  // sum the stage's A, free it; one sum a tile
      __shared__ float warp_sums[8];
      float staged = 0.f;
      for (int t = 0; t < p.kt_total; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        staged += stage_sum<kA>(smem + s * kStageBytes, tid - 128);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) staged += __shfl_xor_sync(0xffffffffu, staged, o);
      if (lane == 0) warp_sums[tid / 32 - 4] = staged;
      consumers_sync();
      if (tid == 128 && tile % p.geo.n_blocks == 0) {
        float sum = 0.f;
        for (int w = 0; w < 8; ++w) sum += warp_sums[w];
        p.sums[tile / p.geo.n_blocks] = sum;
      }
      consumers_sync();  // warp_sums is read before the next rep writes it
      continue;
    }
    float acc[MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;
    for (int t = 0; t < p.kt_total; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a = smem_u32(smem + s * kStageBytes) + g * MT * kM64Bytes;
      const uint32_t b = smem_u32(smem + s * kStageBytes + kA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          Wgmma<BN>::mma(acc[mt], desc_a(a + (kk >> 1) * kAHalf + mt * kM64Bytes + (kk & 1) * 32),
                         desc_b(b + kk * 16 * 128));
      wgmma_commit();
      if (t > 0) {  // k-tile it-1's products are done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) pin(acc[mt][e]);
    if constexpr (HEAD) {  // K9: the head's sums and tanh, no relu plane stored
      head_epilogue<BN, MT>(cv, acc, reinterpret_cast<const float*>(plan + runs), m0, g, warp,
                            lane, q, M);
      continue;
    }

    // Epilogue: quad_columns gives each lane 8 consecutive columns of a row.
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi) {
      const int mt = mi / 2, i = mi % 2;
      const int64_t m = m0 + (g * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * i;
      const Origin o = origin(n, m);
      const int64_t pos = ((int64_t)o.b * side + o.y + 1) * side + o.x + 1;
      float pm[kSlots][8];  // K2: the max so far of each pooled channel's rounded values
      if constexpr (POOL) {
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
          for (int e = 0; e < 8; ++e) pm[sl][e] = 0.f;
      }
#pragma unroll
      for (int G = 0; G < BN / 32; ++G) {
        float v[8];
        quad_columns<BN>(acc[mt], G, i, q, lane, v);
        const int col = n0 + 8 * (4 * G + q);
        if (m >= M || col >= co4) continue;
        if constexpr (PHASE != kProbeNoEpi) add_bias(cv.bias, col, v);  // no_epi: the raw sums
        if (cv.epilogue == kRelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        } else if (cv.epilogue == kFilm) {  // the trunk is the input at the same position
          Pack tr;
          tr.u = *reinterpret_cast<const uint4*>(cv.x[0] + pos * cv.c4[0] + col);
          const float4* gm = reinterpret_cast<const float4*>(cv.gamma + (int64_t)o.b * co4 + col);
          const float4* bt = reinterpret_cast<const float4*>(cv.beta + (int64_t)o.b * co4 + col);
          const float4 g0 = gm[0], g1 = gm[1], t0 = bt[0], t1 = bt[1];
          const float gamma[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float beta[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = film_site(v[e], gamma[e], beta[e], __bfloat162float(tr.v[e]));
        }
        const Pack out = store_bf16(cv.out + pos * co4 + col, v);
        if constexpr (POOL) {  // the pool takes the stored (rounded) values
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float r = __bfloat162float(out.v[e]);
            pm[G % kSlots][e] = G < kSlots ? r : fmaxf(pm[G % kSlots][e], r);
          }
        }
      }
      if constexpr (POOL) {
        const int cp = co4 / 4;
        if constexpr (BN == 64) {  // the max over the quad's lanes with the same channels
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            pm[0][e] = fmaxf(pm[0][e], __shfl_xor_sync(0xffffffffu, pm[0][e], 2));
            if (cp == 8) pm[0][e] = fmaxf(pm[0][e], __shfl_xor_sync(0xffffffffu, pm[0][e], 1));
          }
        }
        if (m < M && 8 * q < cp) {
          const int half = n / 2 + 2;
          __nv_bfloat16* dst =
              cv.pooled + 8 * q +
              (cv.pool == kPoolPixel
                   ? (((int64_t)o.b * n + o.y) * n + o.x) * cp
                   : (((int64_t)o.b * half + o.y / 2 + 1) * half + o.x / 2 + 1) * co4 +
                         (2 * (o.y & 1) + (o.x & 1)) * cp);
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) {
            store_bf16(dst + 32 * sl, pm[sl]);
          }
        }
      }
    }
    }  // reps
  }
}

constexpr int kMaxSlots = 2 * kBM / 64 + 2;  // a tile of four 64-pixel rows and its two below

struct alignas(64) WinParams {
  CUtensorMap x_map;  // the plane as (4C, P, P, B), box (8, n+2, 1, 1), no swizzle: a row's chunk
  CUtensorMap b_map;  // the weights as (co4, k), box (64, 64)
  Conv conv;
  Window win;
  int units;          // work units an image
  int kt;             // k-tiles: 4C / 16
};

// P2 (see Window in s2d_wgmma.cuh): a persistent block walks work units
// blockIdx.x, + grid, ...; its producer thread loads each unit's input rows
// once into the slot ring (row j of the block's walk in slot j % slots) and
// streams B for each tile and column block; the consumer
// warpgroups take a unit's output rows `rows` at a time, as K1's tile: m64
// tile g MT + mt is output row (64 (g MT + mt)) / wrow at pixel
// (64 (g MT + mt)) % wrow. A tile's rows are freed once its last column
// block's products are done, before its epilogue, except the two the next
// tile reads again. The producer issues a tile's first b_stages B stages
// before its rows (they wait only on the previous tile's products), so that
// B is in place when the freed slots have been refilled.
template <int BN, int MT>
__global__ void __launch_bounds__(kThreadsWg, 1) rowblk_wgmma(const __grid_constant__ WinParams p) {
  constexpr int kBStage = BN * kBK * 2, kSteps = kBK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full_b[kStages], empty_b[kStages];
  __shared__ __align__(8) uint64_t full_w[kMaxSlots], empty_w[kMaxSlots];

  const Conv& cv = p.conv;
  const Window& w = p.win;
  const int tid = threadIdx.x, n = cv.n, side = n + 2, c4 = cv.c4[0], co4 = cv.co4;
  const int sbytes = slot_bytes(c4, w.pitch), lead = w.pitch * 16, per = w.n_blocks * p.kt;
  unsigned char* win = smem + w.b_stages * kBStage;
  // The step plan: of each 16-deep step, the window offset of its first
  // chunk at pixel dx of the slot, and dy slots' bytes.
  int2* plan = reinterpret_cast<int2*>(win + w.slots * sbytes);
  for (int j = tid; j < p.kt * kSteps; j += kThreadsWg) {
    const Chunk ck = chunk(kGatherConv3x3, c4, j * 16);
    plan[j] = make_int2(ck.c / 8 * lead + ck.dx * 16, ck.dy * sbytes);
  }
  if (tid == 0) {
    for (int s = 0; s < w.b_stages; ++s) mbar_init(&full_b[s], 1), mbar_init(&empty_b[s], 8);
    for (int s = 0; s < w.slots; ++s) mbar_init(&full_w[s], 1), mbar_init(&empty_w[s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_ring(cv.out, cv.batch, side, co4, (int64_t)blockIdx.x * kThreadsWg + tid,
            (int64_t)gridDim.x * kThreadsWg);
  __syncthreads();
  const int units = cv.batch * p.units;

  if (tid < 128) {  // the producer warpgroup: one thread issues every box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tid != 0) return;
    int gi = 0, bt = 0;  // rows loaded, B stages loaded
    const uint32_t row_bytes = (uint32_t)c4 * side * 2;
    auto load_b = [&](int k) {  // k-tile k % kt of column block k / kt
      const int s = bt % w.b_stages;
      if (bt >= w.b_stages) mbar_wait(&empty_b[s], (bt / w.b_stages - 1) & 1);
      mbar_expect_tx(&full_b[s], kBStage);
#pragma unroll
      for (int j = 0; j < BN / kBBox; ++j)
        tma_2d(smem + s * kBStage + j * kBBoxBytes, &p.b_map, &full_b[s], k / p.kt * BN + j * kBBox,
               k % p.kt * kBK);
      ++bt;
    };
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / p.units;
      int ya, yb;
      unit_rows(n, p.units, u % p.units, &ya, &yb);
      const int rows_u = yb - ya;
      for (int t0 = 0, next = 0; t0 < rows_u; t0 += w.rows) {
        for (int k = 0; k <= per; ++k) {
          if (k == min(w.b_stages, per)) {  // the tile's rows, once its first B stages are issued
            for (const int need = min(t0 + w.rows + 2, rows_u + 2); next < need; ++next, ++gi) {
              const int sl = gi % w.slots;
              if (gi >= w.slots) mbar_wait(&empty_w[sl], (gi / w.slots - 1) & 1);
              mbar_expect_tx(&full_w[sl], row_bytes);
              for (int k8 = 0; k8 < c4 / 8; ++k8)
                tma_4d(win + sl * sbytes + k8 * lead, &p.x_map, &full_w[sl], k8 * 8, 0,
                       ya + next, b);
            }
          }
          if (k < per) load_b(k);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31, q = lane & 3;
  const uint32_t win0 = smem_u32(win), b0 = smem_u32(smem), ring = w.slots * sbytes;
  int gi0 = 0, bt = 0;  // the walk's index of the unit's first row; B stages consumed
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b = u / p.units;
    int ya, yb;
    unit_rows(n, p.units, u % p.units, &ya, &yb);
    const int rows_u = yb - ya;
    if (rows_u <= 0) continue;  // a unit of ring rows alone: nothing loaded, nothing to compute
    for (int t0 = 0; t0 < rows_u; t0 += w.rows) {
      const int rg = min(w.rows, rows_u - t0), need = min(t0 + w.rows + 2, rows_u + 2);
      for (int j = t0; j < need; ++j)
        mbar_wait(&full_w[(gi0 + j) % w.slots], ((gi0 + j) / w.slots) & 1);
      // Each m64 tile's A at dy = 0 and dx = 0: its output row's slot (rows
      // past the unit read its last row; their outputs are not stored) at
      // its first pixel.
      uint32_t abase[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int i64 = (g * MT + mt) * 64, r = min(i64 / w.wrow, rg - 1);
        abase[mt] = win0 + (gi0 + t0 + r) % w.slots * sbytes + i64 % w.wrow * 16;
      }
      for (int col = 0; col < w.n_blocks; ++col) {
        float acc[MT][BN / 2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;
        for (int t = 0; t < p.kt; ++t, ++bt) {
          const int s = bt % w.b_stages;
          mbar_wait(&full_b[s], (bt / w.b_stages) & 1);
          const uint32_t bs = b0 + s * kBStage;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            const int2 e = plan[t * kSteps + kk];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a = abase[mt] + e.y;  // slot row + dy, wrapped round the ring
              if (a >= win0 + ring) a -= ring;
              Wgmma<BN>::mma(acc[mt], desc_window(a + e.x, lead), desc_b(bs + kk * 16 * 128));
            }
          }
          wgmma_commit();
          if (t > 0) {  // stage bt-1's products are done: free it
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty_b[(bt - 1) % w.b_stages]);
          }
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(&empty_b[(bt - 1) % w.b_stages]);
          if (col == w.n_blocks - 1) {  // free the rows the next tile does not read
            const int last = t0 + w.rows >= rows_u ? rows_u + 2 : t0 + w.rows;
            for (int j = t0; j < last; ++j) mbar_arrive(&empty_w[(gi0 + j) % w.slots]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) pin(acc[mt][e]);

        // K1's relu epilogue; rows of the tile past the unit or the plane are not stored.
#pragma unroll
        for (int mi = 0; mi < 2 * MT; ++mi) {
          const int mt = mi / 2, i = mi % 2, i64 = (g * MT + mt) * 64, r = i64 / w.wrow;
          const int x = i64 % w.wrow + warp * 16 + (lane >> 2) + 8 * i;
          const bool live = r < rg && x < n;
          const int64_t pos = ((int64_t)b * side + ya + t0 + r + 1) * side + x + 1;
#pragma unroll
          for (int G = 0; G < BN / 32; ++G) {
            float v[8];
            quad_columns<BN>(acc[mt], G, i, q, lane, v);
            const int c = col * BN + 8 * (4 * G + q);
            if (!live || c >= co4) continue;
            add_bias(cv.bias, c, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
            store_bf16(cv.out + pos * co4 + c, v);
          }
        }
      }
    }
    gi0 += rows_u + 2;
  }
}

template <int BN, int MT, bool POOL, int PHASE = kProduction, bool HEAD = false>
cudaError_t launch_bn(const Params& prm, cudaStream_t stream) {
  // The ring, the plan (an int a kVec-deep run), K9's W_head and the 1 KB alignment.
  const int smem = kStages * (MT * kABytes + BN * kBK * 2) + prm.kt_total * (kBK / kVec) * 4 +
                   (HEAD ? BN * 16 * 4 : 0) + 1024;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      s2d_wgmma<BN, MT, POOL, PHASE, HEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)prm.conv.batch * prm.conv.n * prm.conv.n;
  const int64_t tiles = (rows + kBM * MT - 1) / (kBM * MT) * prm.geo.n_blocks;
  s2d_wgmma<BN, MT, POOL, PHASE, HEAD>
      <<<(unsigned)(tiles < sms ? tiles : sms), kThreadsWg, smem, stream>>>(prm);
  return cudaGetLastError();
}

// The instantiation for the launch's tile, pool and head.
template <int BN, int MT>
cudaError_t launch_tile(const Params& prm, cudaStream_t stream) {
  if (prm.conv.epilogue == kHead) return launch_bn<BN, MT, false, kProduction, true>(prm, stream);
  if (prm.conv.pool == kPoolNone) return launch_bn<BN, MT, false>(prm, stream);
  if constexpr (BN == 64 || BN == 128 || BN == 256) return launch_bn<BN, MT, true>(prm, stream);
  return cudaErrorInvalidValue;
}

// P1's instantiation for the launch's tile: 4Co of one block of 64 or 128.
template <int PHASE>
cudaError_t launch_phase(const Params& prm, cudaStream_t stream) {
  const bool two = prm.geo.bm == 2 * kBM;
  if (prm.geo.bn == 64)
    return two ? launch_bn<64, 2, false, PHASE>(prm, stream)
               : launch_bn<64, 1, false, PHASE>(prm, stream);
  if (prm.geo.bn == 128)
    return two ? launch_bn<128, 2, false, PHASE>(prm, stream)
               : launch_bn<128, 1, false, PHASE>(prm, stream);
  return cudaErrorInvalidValue;
}

// The launch's geometry and tensor maps; an error code for what the
// mainloop does not take.
cudaError_t prepare(const Conv& cv, Params& prm) {
  if (cv.batch <= 0 || !takes(cv.gather, cv.n, cv.c4, cv.n_ops, cv.co4, cv.pool))
    return cudaErrorInvalidValue;
  if (cv.epilogue != kRelu && cv.epilogue != kFilm && cv.epilogue != kNone &&
      cv.epilogue != kHead)
    return cudaErrorInvalidValue;
  if (cv.epilogue == kHead &&  // one 3x3 operand, every column in one block, h4 <= 16
      (cv.gather != kGatherConv3x3 || cv.n_ops != 1 || cv.pool != kPoolNone || cv.co4 > 256 ||
       cv.h4 <= 0 || cv.h4 > 16 || cv.w_head == nullptr || cv.b_head == nullptr ||
       cv.head_out == nullptr))
    return cudaErrorInvalidValue;
  if (cv.epilogue == kFilm &&
      (cv.gather != kGatherConv3x3 || cv.n_ops != 1 || cv.c4[0] != cv.co4))
    return cudaErrorInvalidValue;
  if (cv.pool != kPoolNone && (cv.epilogue != kRelu || cv.pooled == nullptr))
    return cudaErrorInvalidValue;
  prm.conv = cv;
  prm.geo = geometry(cv.gather, cv.n, cv.c4, cv.n_ops, cv.co4);
  prm.kt0 = (depth(cv.gather, cv.c4[0]) + kBK - 1) / kBK;
  prm.kt_total = prm.kt0 + (cv.n_ops > 1 ? (depth(cv.gather, cv.c4[1]) + kBK - 1) / kBK : 0);
  const cuuint64_t side = cv.n + 2;
  for (int o = 0; o < cv.n_ops; ++o) {
    const cuuint64_t c4 = cv.c4[o];  // B's rows past K and columns past 4Co read as zeros
    const cuuint64_t w_dims[2] = {(cuuint64_t)cv.co4, (cuuint64_t)depth(cv.gather, cv.c4[o])};
    const cuuint64_t w_strides[1] = {(cuuint64_t)cv.co4 * 2};
    const cuuint32_t w_box[2] = {kBBox, kBK};
    if (!encode(&prm.b_map[o], cv.w[o], 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    if (prm.geo.route != kRouteTma) continue;
    const cuuint64_t x_dims[4] = {c4, side, side, (cuuint64_t)cv.batch};
    const cuuint64_t x_strides[3] = {c4 * 2, side * c4 * 2, side * side * c4 * 2};
    const cuuint32_t x_box[4] = {(cuuint32_t)prm.geo.box[0], (cuuint32_t)prm.geo.box[1],
                                 (cuuint32_t)prm.geo.box[2], (cuuint32_t)prm.geo.box[3]};
    if (!encode(&prm.a_map[o], cv.x[o], 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

cudaError_t conv(const Conv& cv, cudaStream_t stream) {
  Params prm{};
  const cudaError_t err = prepare(cv, prm);
  if (err != cudaSuccess) return err;
  if (prm.geo.bm == 2 * kBM) return prm.geo.bn == 64 ? launch_tile<64, 2>(prm, stream)
                                                     : launch_tile<128, 2>(prm, stream);
  switch (prm.geo.bn) {
    case 64: return launch_tile<64, 1>(prm, stream);
    case 128: return launch_tile<128, 1>(prm, stream);
    case 192: return launch_tile<192, 1>(prm, stream);
    case 256: return launch_tile<256, 1>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t probe(const Conv& cv, int phase, const __nv_bfloat16* a_dense, float* sums, int reps,
                  cudaStream_t stream) {
  if (reps < 1 || cv.gather != kGatherConv3x3 || cv.n_ops != 1 || cv.pool != kPoolNone ||
      cv.epilogue != (phase == kProbeNoEpi ? kNone : kRelu) ||
      (phase == kProbeMatmulOnly && a_dense == nullptr) ||
      (phase == kProbeStageOnly && sums == nullptr))
    return cudaErrorInvalidValue;
  Params prm{};
  cudaError_t err = prepare(cv, prm);
  if (err != cudaSuccess) return err;
  if (prm.geo.n_blocks != 1 || prm.geo.bn > 128) return cudaErrorInvalidValue;
  prm.reps = reps;
  prm.sums = sums;
  if (phase == kProbeMatmulOnly) {  // the dense taps (M, 16C) in 32-deep boxes of bm rows
    const cuuint64_t dims[2] = {(cuuint64_t)4 * cv.c4[0], (cuuint64_t)cv.batch * cv.n * cv.n};
    const cuuint64_t strides[1] = {dims[0] * 2};
    const cuuint32_t box[2] = {kHalf, (cuuint32_t)prm.geo.bm};
    if (!encode(&prm.a_map[0], a_dense, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  switch (phase) {
    case kProbeFull: return launch_phase<kProbeFull>(prm, stream);
    case kProbeNoEpi: return launch_phase<kProbeNoEpi>(prm, stream);
    case kProbeMatmulOnly: return launch_phase<kProbeMatmulOnly>(prm, stream);
    case kProbeStageOnly: return launch_phase<kProbeStageOnly>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

namespace {

template <int BN, int MT>
cudaError_t launch_rowblk(const WinParams& prm, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      rowblk_wgmma<BN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, prm.win.smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int units = prm.conv.batch * prm.units;
  rowblk_wgmma<BN, MT><<<(unsigned)(units < sms ? units : sms), kThreadsWg, prm.win.smem,
                         stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

cudaError_t rowblk(const Conv& cv, int units, cudaStream_t stream) {
  WinParams prm{};
  prm.win = window(cv.n, cv.c4[0], cv.co4);
  if (prm.win.bm == 0 || cv.batch <= 0 || cv.gather != kGatherConv3x3 || cv.n_ops != 1 ||
      cv.pool != kPoolNone || cv.epilogue != kRelu || units < 1 || (cv.n + 2) % units != 0)
    return cudaErrorInvalidValue;
  prm.conv = cv;
  prm.units = units;
  prm.kt = 4 * cv.c4[0] / kBK;
  const cuuint64_t side = cv.n + 2, c4 = cv.c4[0];
  const cuuint64_t w_dims[2] = {(cuuint64_t)cv.co4, 4 * c4};
  const cuuint64_t w_strides[1] = {(cuuint64_t)cv.co4 * 2};
  const cuuint32_t w_box[2] = {kBBox, kBK};
  const cuuint64_t x_dims[4] = {c4, side, side, (cuuint64_t)cv.batch};
  const cuuint64_t x_strides[3] = {c4 * 2, side * c4 * 2, side * side * c4 * 2};
  const cuuint32_t x_box[4] = {kVec, (cuuint32_t)side, 1, 1};
  if (!encode(&prm.b_map, cv.w[0], 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&prm.x_map, cv.x[0], 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const bool two = prm.win.bm == 2 * kBM;
  switch (prm.win.bn) {
    case 64: return two ? launch_rowblk<64, 2>(prm, stream) : launch_rowblk<64, 1>(prm, stream);
    case 128: return two ? launch_rowblk<128, 2>(prm, stream) : launch_rowblk<128, 1>(prm, stream);
    case 192: return launch_rowblk<192, 1>(prm, stream);
    case 256: return launch_rowblk<256, 1>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace depgan

// The launch plan of a K1 or K2 (c4b = 0), K3, or K7 (gather 2) launch as
// the kernel takes it: out[0..7] = route, bm, bn, n_blocks, box[4]; then, for
// each run of GEMM depth the producer loads in one piece (kHalf deep by TMA,
// kVec by cp.async), in k order over operand 0 then 1, up to each operand's K
// rounded up to whole k-tiles, (operand, channel, dx, dy), or (operand, -1,
// 0, 0) past K. gather and pool are the engine's Gather and PoolMode. Returns
// the number of ints written, or -1 for widths the mainloop refuses (takes())
// or if they would not fit in cap.
extern "C" int depgan_wgmma_plan(int n, int c4a, int c4b, int co4, int gather, int pool, int* out,
                                 int cap) {
  using namespace depgan::wg;
  const int c4[2] = {c4a, c4b};
  const int n_ops = c4b != 0 ? 2 : 1;
  if (!takes(gather, n, c4, n_ops, co4, pool)) return -1;
  const Geometry g = geometry(gather, n, c4, n_ops, co4);
  const int run = g.route == kRouteTma ? kHalf : kVec;
  int w = 0;
  const int head[8] = {g.route, g.bm, g.bn, g.n_blocks, g.box[0], g.box[1], g.box[2], g.box[3]};
  for (int v : head) {
    if (w >= cap) return -1;
    out[w++] = v;
  }
  for (int o = 0; o < n_ops; ++o) {
    const int k = (depth(gather, c4[o]) + kBK - 1) / kBK * kBK;
    for (int k0 = 0; k0 < k; k0 += run) {
      if (w + 4 > cap) return -1;
      const int e = plan_entry(gather, c4[o], k0);  // decoded as the producer decodes it
      const bool past = e == kPast;
      out[w++] = o, out[w++] = past ? -1 : e & 0xFFFF, out[w++] = past ? 0 : (e >> 16) & 15;
      out[w++] = past ? 0 : e >> 20;
    }
  }
  return w;
}

namespace {

// K1's relu conv of one bf16 3x3 operand, as a wg::Conv.
depgan::wg::Conv relu_conv(const void* x, const void* w4, const void* bias, void* out, int batch,
                           int n, int c4, int co4) {
  using namespace depgan;
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w4);
  cv.c4[0] = c4;
  cv.gather = kGatherConv3x3, cv.n_ops = 1, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = kRelu, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.out = static_cast<__nv_bfloat16*>(out);
  return cv;
}

}  // namespace

// P1 in bf16 on the mainloop. phase: 1 = full, 2 = no_epi, 3 = matmul_only
// (reads a_dense, the (batch*n*n, 4*c4) gathered taps, not x), 4 =
// stage_only (writes sums, one float a tile of the geometry's bm rows, not
// out). The relu conv's arguments as depgan_conv3x3_s2d_fused; 4Co of one
// block of at most 128 columns.
extern "C" int depgan_wgmma_probe(int phase, const void* x, const void* a_dense, const void* w4,
                                  const void* bias, void* out, void* sums, int batch, int n, int c4,
                                  int co4, int reps, void* stream) {
  using namespace depgan;
  wg::Conv cv = relu_conv(x, w4, bias, out, batch, n, c4, co4);
  if (phase == kProbeNoEpi) cv.epilogue = kNone;
  return wg::probe(cv, phase, static_cast<const __nv_bfloat16*>(a_dense), static_cast<float*>(sums),
                   reps, static_cast<cudaStream_t>(stream));
}

// P2 in bf16 on the mainloop: the relu conv with `units` row blocks an
// image (units divides n+2); arguments as depgan_conv3x3_rowblk.
extern "C" int depgan_conv3x3_rowblk_wgmma(const void* x, const void* w4, const void* bias,
                                           void* out, int batch, int n, int c4, int co4, int units,
                                           void* stream) {
  return depgan::wg::rowblk(relu_conv(x, w4, bias, out, batch, n, c4, co4), units,
                            static_cast<cudaStream_t>(stream));
}

// P2's window as the kernel takes it: out[0..8] = bm, bn, n_blocks, wrow,
// rows, pitch, slots, b_stages, smem; then, for each 16-deep step in k order,
// (channel, dx, dy): what it reads at slot row +dy, pixel +dx. Returns the
// number of ints written, or -1 for widths the kernel refuses or if they
// would not fit in cap.
extern "C" int depgan_rowblk_plan(int n, int c4, int co4, int* out, int cap) {
  using namespace depgan::wg;
  const Window w = window(n, c4, co4);
  if (w.bm == 0) return -1;
  const int head[9] = {w.bm,    w.bn,    w.n_blocks, w.wrow, w.rows,
                       w.pitch, w.slots, w.b_stages, w.smem};
  int k = 0;
  for (int v : head) {
    if (k >= cap) return -1;
    out[k++] = v;
  }
  for (int k0 = 0; k0 < 4 * c4; k0 += 16) {
    if (k + 3 > cap) return -1;
    const Chunk ck = chunk(depgan::kGatherConv3x3, c4, k0);
    out[k++] = ck.c, out[k++] = ck.dx, out[k++] = ck.dy;
  }
  return k;
}
