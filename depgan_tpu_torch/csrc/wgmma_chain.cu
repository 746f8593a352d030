// K10 in bf16 for Hopper (sm_90a): a whole generator site, three chained
// 3x3 s2d convs, as one wgmma kernel whose two intermediate planes live in
// shared memory; the design is ChainPlan in s2d_wgmma.cuh.
//
// Replaces, in bf16, conv3x3_s2d_chain3 (depgan_tpu/ops/conv_s2d_pallas.py
// :1741, kernel _kernel_chain3 :1610): conv_in (one operand, or the
// two-operand decoder conv over (up, skip)) -> FiLM site -> conv_out, with
// the 2x2 max-pool of conv_out when asked. On the serving forward under
// fuse_chain: m1 (n 128, 32 -> 128 -> 128, pool s2d), m2 (n 64, 128 -> 256
// -> 256, pool pixel), p2 (n 64, 384 + 256 -> 256 -> 256) and p1 (n 128,
// 256 + 128 -> 128 -> 128). float32 K10 and K12 (chain2) stay on s2d_chain
// (chain_kernels.cu), and so does bf16 K10 as the old route that
// chip_smoke.py times beside this one.
//
// Bound: each site does ~300-900 FLOP per byte of its input and output
// planes, above the H100's bf16 ridge, so its operations bound it; the
// halo each tile recomputes adds products (T = 12 at level 1: 768 GEMM rows
// for 144 outputs, 1.78x the sequential kernels'; T = 8 at level 2: 512 for
// 64, 2.67x). s2d_chain ran the engine's wmma with a block-wide barrier
// every 32 deep and T = 8 everywhere. Here the products are wgmma m64nBNk16
// with BN = 4Cm, fed as the mainloop's: one producer warpgroup (TMA, or
// cp.async for the C = 8 entry conv) and two consumer warpgroups, one
// persistent block an SM, a ring of k-tiles 64 deep guarded by full and
// empty mbarriers and shared by the three stages' B. setmaxnreg gives the
// producer 88 registers and a consumer 208 (the mainloop's 56 and 224
// spilled the producer's walk over stages, passes and tiles). Stage 0's A arrives
// in the ring (its halves in region 1, which that stage does not read);
// stages 1 and 2 read A from regions 0 and 1 through non-swizzled
// descriptors at a tap's shifted address. The epilogues run from
// registers: stage 0 relu into region 0, stage 1 the FiLM site (trunk from
// region 0) into region 1, stage 2 relu into the output plane with K2's
// pool in registers. Each stage sums its k-tiles in order in 16-deep steps
// with the sequential kernel's instruction and rounds to bf16 where the
// sequential kernels store, so K10 equals K1/K3 -> K1 film -> K1/K2 on the
// mainloop bit for bit.

#include "wgmma_device.cuh"

namespace depgan {
namespace wg {
namespace {

struct alignas(64) ChainParams {
  CUtensorMap a_map[2];  // stage 0's planes as (4C, P, P, B), box (32, pitch, prow[0], 1); TMA route
  CUtensorMap b_map[4];  // stage 0's operands', stage 1's, stage 2's weights as (4Cm, k), box (64, 64)
  Chain ch;
  ChainPlan plan;
  int kt[4];       // k-tiles: stage 0's operand 0, operand 1 (0 if one), stage 1, stage 2
  int tiles_side;  // tiles along a side: n / T rounded up
};

// The tile's output positions: padded rows Y0 .. Y0 + T - 1, columns X0 ..
// of image b.
struct TileAt {
  int b, y0, x0;
};
__device__ __forceinline__ TileAt tile_at(const ChainParams& p, int64_t tile) {
  const int ts = p.tiles_side, T = p.plan.tile;
  const int64_t per = (int64_t)ts * ts;
  const int r = (int)(tile % per);
  return {(int)(tile / per), 1 + r / ts * T, 1 + r % ts * T};
}

__device__ __forceinline__ bool interior(int y, int x, int n) {
  return y >= 1 && y <= n && x >= 1 && x <= n;
}

// MT m64 tiles a consumer warpgroup (a pass is 128 MT GEMM rows), BN = 4Cm
// columns. POOL: K2's pooled epilogue at stage 2, a separate instantiation
// so the others keep theirs lean.
template <int BN, int MT, bool POOL>
__global__ void __launch_bounds__(kThreadsWg, 1) chain_wgmma(const __grid_constant__ ChainParams p) {
  constexpr int kAStage = MT * kABytes, kAHalf = MT * kAHalfBytes;
  constexpr int kBStage = BN * kBK * 2, kSteps = kBK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], r1_free;

  const Chain& ch = p.ch;
  const ChainPlan& pl = p.plan;
  const int tid = threadIdx.x, n = ch.n, side = n + 2, c4m = ch.c4m;
  const int T = pl.tile, pitch = pl.pitch, S = pl.stages;
  const bool tma = pl.route == kRouteTma;
  unsigned char* const region1 = smem + pl.region;  // region 0 at smem; region 1 also holds
  unsigned char* const bring = region1 + pl.area1;  // stage 0's A ring
  // The plans: stage 0's (channel, dx, dy) of every kVec-deep run of each
  // operand (plan_entry), and of each 16-deep step of stages 1 and 2 the
  // region offset from a GEMM row's own pixel: chunk, then dy rows and dx
  // pixels of the pitch.
  int* plan0 = reinterpret_cast<int*>(bring + S * kBStage);
  const int kt0 = p.kt[0] + p.kt[1], runs0 = p.kt[0] * (kBK / kVec);
  int* steps = plan0 + kt0 * (kBK / kVec);
  for (int j = tid; j < kt0 * (kBK / kVec); j += kThreadsWg) {
    const int op = j < runs0 ? 0 : 1;
    plan0[j] = plan_entry(kGatherConv3x3, ch.c4[op], (j - (op ? runs0 : 0)) * kVec);
  }
  for (int j = tid; j < c4m / 4; j += kThreadsWg) {
    const Chunk ck = chunk(kGatherConv3x3, c4m, j * 16);
    steps[j] = ck.c / 8 * pl.lead + (ck.dy * pitch + ck.dx) * 16;
  }
  for (int i = tid; i < 2 * pl.region / 16; i += kThreadsWg)  // junk rows read zeros
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();  // ... before TMA and wgmma see the same bytes
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], tma ? 1 : 1 + 128);  // expect_tx, and each cp.async producer thread
      mbar_init(&empty[s], 8);                 // lane 0 of each consumer warp
    }
    mbar_init(&r1_free, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int64_t ring0 = (int64_t)blockIdx.x * kThreadsWg + tid;
  const int64_t ring_step = (int64_t)gridDim.x * kThreadsWg;
  zero_ring(ch.out, ch.batch, side, c4m, ring0, ring_step);
  if (POOL && ch.pool == kPoolS2d) zero_ring(ch.pooled, ch.batch, n / 2 + 2, c4m, ring0, ring_step);
  __syncthreads();
  const int64_t tiles = (int64_t)ch.batch * p.tiles_side * p.tiles_side;

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
    if (tma && tid != 0) return;
    // cp.async: thread tid copies 16-byte run kv of each k-tile for pass
    // rows r0 + 16 i, in the 64-byte swizzle (chunk j of row r at 16 (j ^ (r/2 % 4))).
    const int kv = tid & 7, r0 = tid >> 3;
    const uint32_t a_off = (kv >> 2) * kAHalf + r0 * 64 + (((kv & 3) ^ ((r0 >> 1) & 3)) << 4);
    const uint32_t box_tx = 2u * kHalf * pitch * pl.prow[0] * 2;  // a k-tile's two A boxes
    int it = 0, ti = 0;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
      const TileAt at = tile_at(p, tile);
      for (int s = 0; s < 3; ++s) {
        const int kts = s == 0 ? kt0 : p.kt[s + 1];
        for (int pass = 0; pass < pl.passes[s]; ++pass) {
          // Region 1 holds the ring's A halves: the last tile's stage 2 must be done with it.
          if (s == 0 && pass == 0 && ti > 0) mbar_wait(&r1_free, (ti - 1) & 1);
          const int f0 = pass * pl.prow[0] * pitch;
          const int live = min(pl.prow[0], chain_rows(T, 0) - pass * pl.prow[0]) * pitch;
          for (int t = 0; t < kts; ++t, ++it) {
            const int slot = it % S, op = s == 0 && t >= p.kt[0] ? 1 : 0;
            if (it >= S) mbar_wait(&empty[slot], (it / S - 1) & 1);
            unsigned char* a = region1 + slot * kAStage;
            const int k0 = (t - (op ? p.kt[0] : 0)) * kBK;
            if (tid == 0) {
              mbar_expect_tx(&full[slot], (s == 0 && tma ? box_tx : 0) + kBStage);
              if (s == 0 && tma) {  // padded rows from Y0 - 3 + dy, columns from X0 - 3 + dx
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int e = plan0[t * (kBK / kVec) + h * (kHalf / kVec)];
                  tma_4d(a + h * kAHalf, &p.a_map[op], &full[slot], e & 0xFFFF,
                         at.x0 - 3 + ((e >> 16) & 15), at.y0 - 3 + pass * pl.prow[0] + (e >> 20),
                         at.b);
                }
              }
#pragma unroll
              for (int j = 0; j < BN / kBBox; ++j)
                tma_2d(bring + slot * kBStage + j * kBBoxBytes, &p.b_map[s == 0 ? op : s + 1],
                       &full[slot], j * kBBox, k0);
            }
            if (tma) continue;
            if (s == 0) {  // rows off the plane's interior load zeros: their outputs are zeros
              const int e = plan0[t * (kBK / kVec) + kv], c4 = ch.c4[op];
              const int dx = (e >> 16) & 15, dy = e >> 20;
              const __nv_bfloat16* x = ch.x[op];
              for (int i = 0; i < 8 * MT; ++i) {
                const int r = r0 + 16 * i, f = f0 + r;
                const int yp = at.y0 - 2 + f / pitch, xp = at.x0 - 2 + f % pitch;
                const bool ok = r < live && interior(yp, xp, n);
                const int64_t at_px = ((int64_t)at.b * side + yp - 1 + dy) * side + xp - 1 + dx;
                cp_async16(a + a_off + i * 1024, ok ? x + at_px * c4 + (e & 0xFFFF) : x, ok);
              }
            }
            cp_async_commit();  // landed, fenced, announced before the next k-tile
            cp_async_wait<0>();
            fence_proxy_async();
            mbar_arrive(&full[slot]);
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroups: rows 64 MT g .. 64 MT (g + 1) - 1 of each pass.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int g = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31, q = lane & 3;
  const uint32_t reg0 = smem_u32(smem), reg1 = smem_u32(region1), b0 = smem_u32(bring);
  constexpr int kSlots = BN == 256 ? 2 : 1;  // K2's pool: see s2d_wgmma in wgmma_kernels.cu
  int it = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt at = tile_at(p, tile);
    // Unrolled: each stage's A and epilogue are compiled for it alone.
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int kts = s == 0 ? kt0 : p.kt[s + 1], prow = pl.prow[s];
      for (int pass = 0; pass < pl.passes[s]; ++pass) {
        const int f0 = pass * prow * pitch;
        const int live = min(prow, chain_rows(T, s) - pass * prow) * pitch;
        float acc[MT][BN / 2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;
        // Stages 1 and 2: each m64 tile's A at tap (0, 0) in the previous region.
        const uint32_t prev = (s == 1 ? reg0 : reg1) + (f0 + g * MT * 64) * 16;
        for (int t = 0; t < kts; ++t, ++it) {
          const int slot = it % S;
          mbar_wait(&full[slot], (it / S) & 1);
          const uint32_t bs = b0 + slot * kBStage;
          wgmma_fence();
          if (s == 0) {
            const uint32_t a = reg1 + slot * kAStage + g * MT * kM64Bytes;
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                Wgmma<BN>::mma(acc[mt],
                               desc_a(a + (kk >> 1) * kAHalf + mt * kM64Bytes + (kk & 1) * 32),
                               desc_b(bs + kk * 16 * 128));
          } else {
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
              const int e = steps[t * kSteps + kk];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                Wgmma<BN>::mma(acc[mt], desc_window(prev + mt * 64 * 16 + e, pl.lead),
                               desc_b(bs + kk * 16 * 128));
            }
          }
          wgmma_commit();
          if (t > 0) {  // k-tile it-1's products are done: free its stage
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
          }
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(&empty[(it - 1) % S]);
          if (s == 2 && pass == pl.passes[2] - 1) mbar_arrive(&r1_free);  // region 1 is read
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) pin(acc[mt][e]);

        // Epilogue: row f = f0 + i64 of the stage's region grid is region
        // position (f / pitch, f % pitch). Rows past the pass are not
        // stored; stage 0 and 1 store zeros off the plane's interior and
        // past their side, stage 2 stores the tile's own positions alone.
#pragma unroll
        for (int mi = 0; mi < 2 * MT; ++mi) {
          const int mt = mi / 2, i = mi % 2;
          const int i64 = (g * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * i, f = f0 + i64;
          const int ry = f / pitch, rx = f % pitch;
          const int yp = at.y0 - 2 + s + ry, xp = at.x0 - 2 + s + rx;  // padded position
          const bool in_pass = i64 < live;
          const bool keep = interior(yp, xp, n) && rx < T + 4 - 2 * s;
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
            const int col = 8 * (4 * G + q);
            if (!in_pass) continue;
            if (s < 2) {
              unsigned char* dst = smem + s * pl.region + col / 8 * pl.lead + f * 16;
              if (!keep) {
                *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
                continue;
              }
              add_bias(ch.bias[s], col, v);
              if (s == 0) {
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
              } else {  // the FiLM site; its trunk is stage 1's input here, in region 0
                Pack tr;
                tr.u = *reinterpret_cast<const uint4*>(smem + col / 8 * pl.lead +
                                                       (f + pitch + 1) * 16);
                const float4* gm = reinterpret_cast<const float4*>(ch.gamma + (int64_t)at.b * c4m + col);
                const float4* bt = reinterpret_cast<const float4*>(ch.beta + (int64_t)at.b * c4m + col);
                const float4 g0 = gm[0], g1 = gm[1], t0 = bt[0], t1 = bt[1];
                const float gamma[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
                const float beta[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  v[e] = film_site(v[e], gamma[e], beta[e], __bfloat162float(tr.v[e]));
              }
              store_bf16(reinterpret_cast<__nv_bfloat16*>(dst), v);
              continue;
            }
            if (!keep) continue;
            add_bias(ch.bias[2], col, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
            const Pack out =
                store_bf16(ch.out + (((int64_t)at.b * side + yp) * side + xp) * c4m + col, v);
            if constexpr (POOL) {  // the pool takes the stored (rounded) values
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const float r = __bfloat162float(out.v[e]);
                pm[G % kSlots][e] = G < kSlots ? r : fmaxf(pm[G % kSlots][e], r);
              }
            }
          }
          if constexpr (POOL) {
            if (s == 2 && in_pass && keep) {  // at BN = 4Cm a lane's runs hold every group
              const int cp = c4m / 4, half = n / 2 + 2, oy = yp - 1, ox = xp - 1;
              __nv_bfloat16* dst =
                  ch.pooled + 8 * q +
                  (ch.pool == kPoolPixel
                       ? (((int64_t)at.b * n + oy) * n + ox) * cp
                       : (((int64_t)at.b * half + oy / 2 + 1) * half + ox / 2 + 1) * c4m +
                             (2 * (oy & 1) + (ox & 1)) * cp);
#pragma unroll
              for (int sl = 0; sl < kSlots; ++sl) store_bf16(dst + 32 * sl, pm[sl]);
            }
          }
        }
      }
      if (s < 2) {  // region s is written: both warpgroups' stage s + 1 reads all of it
        fence_proxy_async();
        consumers_sync();
      }
    }
  }
}

template <int BN, int MT, bool POOL>
cudaError_t launch_chain(const ChainParams& prm, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      chain_wgmma<BN, MT, POOL>, cudaFuncAttributeMaxDynamicSharedMemorySize, prm.plan.smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)prm.ch.batch * prm.tiles_side * prm.tiles_side;
  chain_wgmma<BN, MT, POOL><<<(unsigned)(tiles < sms ? tiles : sms), kThreadsWg, prm.plan.smem,
                              stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

cudaError_t chain3(const Chain& ch, cudaStream_t stream) {
  ChainParams prm{};
  prm.plan = chain_plan(ch.n, ch.c4, ch.n_ops, ch.c4m, ch.c4m, ch.pool);
  if (prm.plan.bn == 0 || ch.batch <= 0 || ch.gamma == nullptr || ch.beta == nullptr ||
      (ch.pool != kPoolNone) != (ch.pooled != nullptr))
    return cudaErrorInvalidValue;
  prm.ch = ch;
  prm.kt[0] = 4 * ch.c4[0] / kBK;
  prm.kt[1] = ch.n_ops > 1 ? 4 * ch.c4[1] / kBK : 0;
  prm.kt[2] = prm.kt[3] = 4 * ch.c4m / kBK;
  prm.tiles_side = (ch.n + prm.plan.tile - 1) / prm.plan.tile;
  const cuuint64_t side = ch.n + 2, c4m = ch.c4m;
  const cuuint32_t w_box[2] = {kBBox, kBK};
  const cuuint64_t w_strides[1] = {c4m * 2};
  const __nv_bfloat16* ws[4] = {ch.w0[0], ch.w0[1], ch.w1, ch.w2};
  const int ks[4] = {4 * ch.c4[0], 4 * ch.c4[1], 4 * ch.c4m, 4 * ch.c4m};
  for (int j = 0; j < 4; ++j) {
    if (j == 1 && ch.n_ops < 2) continue;
    const cuuint64_t w_dims[2] = {c4m, (cuuint64_t)ks[j]};
    if (!encode(&prm.b_map[j], ws[j], 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  for (int o = 0; o < ch.n_ops && prm.plan.route == kRouteTma; ++o) {
    const cuuint64_t c4 = ch.c4[o];
    const cuuint64_t x_dims[4] = {c4, side, side, (cuuint64_t)ch.batch};
    const cuuint64_t x_strides[3] = {c4 * 2, side * c4 * 2, side * side * c4 * 2};
    const cuuint32_t x_box[4] = {kHalf, (cuuint32_t)prm.plan.pitch, (cuuint32_t)prm.plan.prow[0],
                                 1};
    if (!encode(&prm.a_map[o], ch.x[o], 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  const bool pool = ch.pool != kPoolNone;
  if (prm.plan.bn == 128) return pool ? launch_chain<128, 2, true>(prm, stream)
                                      : launch_chain<128, 2, false>(prm, stream);
  if (prm.plan.bn == 256) return pool ? launch_chain<256, 1, true>(prm, stream)
                                      : launch_chain<256, 1, false>(prm, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace depgan

// K10 in bf16 on the wgmma machinery: stage 0 over x1 (c4a) [+ x2 (c4b),
// when x2 is given] -> c4m, relu; stage 1 the FiLM conv c4m -> c4m with
// gamma, beta (batch, c4m); stage 2 the relu conv c4m -> c4o (= c4m), with
// pool 0 = none, 1 = pixel, 2 = s2d of its stored output. Takes what
// chain_plan takes.
extern "C" int depgan_conv3x3_s2d_chain3_wgmma(const void* x1, const void* x2, const void* w1a,
                                               const void* w1b, const void* b1, const void* w2,
                                               const void* b2, const void* w3, const void* b3,
                                               const void* gamma, const void* beta, void* out,
                                               void* pooled, int batch, int n, int c4a, int c4b,
                                               int c4m, int c4o, int pool, void* stream) {
  using namespace depgan;
  if (c4o != c4m || (x2 != nullptr) != (w1b != nullptr)) return cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  wg::Chain ch{};
  ch.x[0] = static_cast<bf>(x1), ch.x[1] = static_cast<bf>(x2);
  ch.w0[0] = static_cast<bf>(w1a), ch.w0[1] = static_cast<bf>(w1b);
  ch.c4[0] = c4a, ch.c4[1] = c4b, ch.n_ops = x2 != nullptr ? 2 : 1;
  ch.w1 = static_cast<bf>(w2), ch.w2 = static_cast<bf>(w3);
  ch.bias[0] = static_cast<const float*>(b1), ch.bias[1] = static_cast<const float*>(b2);
  ch.bias[2] = static_cast<const float*>(b3);
  ch.gamma = static_cast<const float*>(gamma), ch.beta = static_cast<const float*>(beta);
  ch.batch = batch, ch.n = n, ch.c4m = c4m, ch.pool = pool;
  ch.out = static_cast<__nv_bfloat16*>(out), ch.pooled = static_cast<__nv_bfloat16*>(pooled);
  return wg::chain3(ch, static_cast<cudaStream_t>(stream));
}

// K10's plan as the kernel takes it (c4b = 0 for one operand): out[0..16] =
// route, bn, mt, tile, pitch, prow[3], passes[3], rpx, lead, region, area1,
// stages, smem. Returns the number of ints written, or -1 for widths the
// kernel refuses or if they would not fit in cap.
extern "C" int depgan_chain_plan(int n, int c4a, int c4b, int c4m, int c4o, int pool, int* out,
                                 int cap) {
  using namespace depgan::wg;
  const int c4[2] = {c4a, c4b};
  const ChainPlan p = chain_plan(n, c4, c4b != 0 ? 2 : 1, c4m, c4o, pool);
  if (p.bn == 0 || cap < 17) return -1;
  const int v[17] = {p.route,     p.bn,        p.mt,        p.tile,      p.pitch,  p.prow[0],
                     p.prow[1],   p.prow[2],   p.passes[0], p.passes[1], p.passes[2], p.rpx,
                     p.lead,      p.region,    p.area1,     p.stages,    p.smem};
  for (int k = 0; k < 17; ++k) out[k] = v[k];
  return 17;
}
