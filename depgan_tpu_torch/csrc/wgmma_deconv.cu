// K4 in bf16 for Hopper (sm_90a): the decoder's upsample, deconv_s2d, as a
// persistent wgmma kernel on the machinery of wgmma_device.cuh, kernel
// deconv_wgmma; the plan is DeconvPlan in s2d_wgmma.cuh.
//
// Replaces, in bf16, deconv_s2d_pallas (depgan_tpu/ops/conv_s2d_pallas.py
// :408, kernel _deconv_kernel :328): the 2x2 stride-2 transposed conv +
// bias + relu from the padded s2d plane (B, m+2, m+2, 4C) into the next
// finer level's padded plane (B, 2m+2, 2m+2, 4O),
//   out[b, 2i+p+1, 2j+q+1, :] = relu(x[b, i+1, j+1, (2p+q)C : (2p+q+1)C] @ w2 + b4),
// with its zero ring. float32 K4 stays on the engine (s2d_kernels.cu), and
// so does bf16 as the reference that chip_smoke.py holds this kernel to and
// times it beside.
//
// Bound: the bytes. At the serving forward's p2 -> p1 (m 64, C 64, 4O 256)
// the GEMM is K = 64 deep: at batch 42 it reads 88 MB and writes 363 MB
// (the plane with its ring), ~50 FLOP a byte against the H100's ~295 bf16
// ridge, so the output store is the bound (0.135 ms at 3.35 TB/s). The
// engine ran it as two 128-column blocks (each A tile gathered twice), 2
// k-tiles a block (its 3-stage pipeline never filled) and a store that
// overlapped nothing, at ~1.24 TB/s. Here:
//  - one persistent block an SM walks the tiles (an input row, both its
//    output rows, one column block of up to 256): a producer thread and
//    two consumer warpgroups, the A tile double-buffered;
//  - B (w2, C x 4O: 32 KB at 64 x 256) is loaded once a block and kept, so
//    no tile waits on a B barrier;
//  - each output row's A is one TMA box a 32-deep half of the input plane
//    viewed as (C, 2, 2, m+2, B(m+2)): the sub-pixel interleave x = 2j + q
//    is the box's own order, and the input row is read once;
//  - each m64 tile's output (64 positions x 256 channels, 32 KB) goes from
//    the wgmma fragments (bias, relu, one rounding) by stmatrix into shared
//    memory, with no transposing shuffles, and is sent by TMA stores from a
//    double buffer a consumer, so the stores of one tile drain while the
//    next tile's products and epilogue run.
// Each output sums ceil(C / 16) 16-deep wgmma steps in k order, the
// engine's wmma steps (a K padded to whole k-tiles adds products of
// zeros, skipped here), then bias, relu and one rounding as the engine
// does, so bf16 K4 equals the engine's bit for bit.

#include "wgmma_device.cuh"

namespace depgan {
namespace wg {
namespace {

struct alignas(64) DeconvParams {
  CUtensorMap x_map;    // the input plane as (C, 2, 2, m+2, B(m+2)), box (32, 2, 1, m, 1),
                        // 64-byte swizzle
  CUtensorMap b_map;    // w2 as (4O, C), box (64, 64), 128-byte swizzle
  CUtensorMap out_map;  // the output from interior (1, 1) as (4O, 2m, B(2m+2) - 2), box
                        // (64, 64, 1), 128-byte swizzle: interior rows, stores clipped at 2m
  Conv conv;
  DeconvPlan plan;
};

constexpr int kOutBox = 64 * 64 * 2;  // one staged store box: 64 positions x 64 channels

// Tile t of the walk is input row r = t / n_blocks (image r / m, row r % m)
// at column block t % n_blocks. Its A is two output rows of wrow GEMM rows,
// each `halves` boxes wrow x 64 bytes, in the A stage ti % a_stages.
template <int BN>
__global__ void __launch_bounds__(kThreadsWg, 1)
    deconv_wgmma(const __grid_constant__ DeconvParams p) {
  constexpr int kStageOut = 64 * BN * 2;  // a consumer's m64 output tile, bf16
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full_a[2], empty_a[2], full_b;

  const Conv& cv = p.conv;
  const DeconvPlan& pl = p.plan;
  const int tid = threadIdx.x, m = cv.n / 2, side = cv.n + 2, o4 = cv.co4;
  const int tiles = cv.batch * m * pl.n_blocks;
  unsigned char* a_smem = smem + pl.b_bytes;
  unsigned char* out_smem = a_smem + pl.a_stages * 2 * pl.a_row;
  if (tid == 0) {
    for (int s = 0; s < pl.a_stages; ++s) mbar_init(&full_a[s], 1), mbar_init(&empty_a[s], 8);
    mbar_init(&full_b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_ring(cv.out, cv.batch, side, o4, (int64_t)blockIdx.x * kThreadsWg + tid,
            (int64_t)gridDim.x * kThreadsWg);
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread starts every box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tid != 0) return;
    mbar_expect_tx(&full_b, pl.b_bytes);  // all of B, once: every column block's k-tiles
    for (int nb = 0; nb < pl.n_blocks; ++nb)
      for (int t = 0; t < pl.kt; ++t)
#pragma unroll
        for (int j = 0; j < BN / kBBox; ++j)
          tma_2d(smem + ((nb * pl.kt + t) * (BN / kBBox) + j) * kBBoxBytes, &p.b_map, &full_b,
                 nb * BN + j * kBBox, t * kBK);
    const uint32_t a_tx = 2u * pl.halves * (kHalf * 2 * m * 2);  // two rows of 32 x 2 x m boxes
    int ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
      const int r = tile / pl.n_blocks, b = r / m, i = r % m, s = ti % pl.a_stages;
      if (ti >= pl.a_stages) mbar_wait(&empty_a[s], (ti / pl.a_stages - 1) & 1);
      mbar_expect_tx(&full_a[s], a_tx);
      unsigned char* a = a_smem + s * 2 * pl.a_row;
      for (int pp = 0; pp < 2; ++pp)  // output row 2i + pp reads channel groups 2pp, 2pp + 1
        for (int h = 0; h < pl.halves; ++h)
          tma_5d(a + pp * pl.a_row + h * pl.wrow * 64, &p.x_map, &full_a[s], h * kHalf, 0, pp, 1,
                 b * (m + 2) + i + 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = tid / 128 - 1, ctid = tid & 127, warp = (tid / 32) & 3, lane = tid & 31;
  const int q = lane & 3, nsub = pl.wrow / 64;
  const bool sender = ctid == 0;  // sends the warpgroup's stores and waits on them
  const uint32_t b0 = smem_u32(smem), a0 = smem_u32(a_smem) + g * pl.a_row;
  const uint32_t staged = smem_u32(out_smem) + g * pl.bufs * kStageOut;
  // stmatrix: lane l addresses row l % 8 of matrix l / 8 = 2u + i, i.e. row
  // 8i + l % 8 of the warp's 16 and 8-column block 2 j2 + u.
  const int st_row = warp * 16 + 8 * ((lane >> 3) & 1) + (lane & 7), st_u = lane >> 4;
  int ti = 0, sent = 0;  // tiles taken, m64 output tiles sent
  mbar_wait(&full_b, 0);  // B is kept: the only wait on it
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    const int r = tile / pl.n_blocks, nb = tile % pl.n_blocks;
    const int b = r / m, y = 2 * (r % m) + g, s = ti % pl.a_stages, n0 = nb * BN;
    const uint32_t a = a0 + s * 2 * pl.a_row;
    const uint32_t bs = b0 + nb * pl.kt * BN * kBK * 2;
    mbar_wait(&full_a[s], (ti / pl.a_stages) & 1);
    for (int sub = 0; sub < nsub; ++sub) {
      float acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      wgmma_fence();
      for (int k = 0; k < pl.steps; ++k)
        Wgmma<BN>::mma(acc, desc_a(a + (k >> 1) * pl.wrow * 64 + sub * kM64Bytes + (k & 1) * 32),
                       desc_b(bs + (k >> 2) * BN * kBK * 2 + (k & 3) * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      if (sub == nsub - 1 && lane == 0) mbar_arrive(&empty_a[s]);  // the next A may load here
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) pin(acc[e]);

      // The staging buffer is free once the stores that last read it have.
      const uint32_t buf = staged + (sent % pl.bufs) * kStageOut;
      if (sender) {
        if (pl.bufs == 2) bulk_wait_read<1>();
        else bulk_wait_read<0>();
      }
      warpgroup_sync(g);
      // The fragment's 8-column blocks j, j + 1 (wgmma: lane q holds columns
      // 8j + 2q, + 1 of rows lane / 4 and + 8 of the warp's 16) as four 8 x 8
      // matrices: bias, relu, one rounding, then one stmatrix into box j / 8,
      // each matrix row a 16-byte chunk, 128-byte swizzled as the TMA store
      // reads it (a matrix's 8 rows land in 8 distinct bank groups).
#pragma unroll
      for (int j2 = 0; j2 < BN / 16; ++j2) {
        uint32_t packed[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 2 * j2 + u, col = n0 + 8 * j + 2 * q;
          float2 bias = make_float2(0.f, 0.f);  // columns past 4O are junk the store clips
          if (col < o4) bias = __ldg(reinterpret_cast<const float2*>(cv.bias + col));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                fmaxf(acc[4 * j + 2 * i] + bias.x, 0.f), fmaxf(acc[4 * j + 2 * i + 1] + bias.y, 0.f));
            packed[2 * u + i] = *reinterpret_cast<const uint32_t*>(&v);
          }
        }
        const int j = 2 * j2 + st_u;
        stmatrix_x4(buf + (j >> 3) * kOutBox + st_row * 128 + (((j & 7) ^ (st_row & 7)) << 4),
                    packed);
      }
      fence_proxy_async();  // the staged writes, to the TMA store's proxy
      warpgroup_sync(g);
      if (sender) {  // positions past 2m and channels past 4O are clipped
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_store_3d(&p.out_map, buf + j * kOutBox, n0 + 64 * j, 64 * sub, b * side + y);
        bulk_commit();
      }
      ++sent;
    }
  }
  if (sender) bulk_wait<0>();  // the stores are done before the block leaves
}

template <int BN>
cudaError_t launch_deconv(const DeconvParams& prm, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      deconv_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, prm.plan.smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)prm.conv.batch * (prm.conv.n / 2) * prm.plan.n_blocks;
  deconv_wgmma<BN><<<(unsigned)(tiles < sms ? tiles : sms), kThreadsWg, prm.plan.smem, stream>>>(
      prm);
  return cudaGetLastError();
}

}  // namespace

cudaError_t deconv(const Conv& cv, cudaStream_t stream) {
  DeconvParams prm{};
  if (cv.n % 2 != 0) return cudaErrorInvalidValue;
  const int m = cv.n / 2;
  prm.plan = deconv_plan(m, cv.c4[0], cv.co4);
  if (prm.plan.bn == 0 || cv.batch <= 0 || cv.gather != kGatherDeconv || cv.n_ops != 1 ||
      cv.epilogue != kRelu || cv.pool != kPoolNone)
    return cudaErrorInvalidValue;
  prm.conv = cv;
  const cuuint64_t c = cv.c4[0] / 4, mp = m + 2, o4 = cv.co4, side = cv.n + 2;
  const cuuint64_t x_dims[5] = {c, 2, 2, mp, (cuuint64_t)cv.batch * mp};
  const cuuint64_t x_strides[4] = {c * 2, c * 4, c * 8, mp * c * 8};
  const cuuint32_t x_box[5] = {kHalf, 2, 1, (cuuint32_t)m, 1};
  const cuuint64_t w_dims[2] = {o4, c};  // past C and 4O: zeros
  const cuuint64_t w_strides[1] = {o4 * 2};
  const cuuint32_t w_box[2] = {kBBox, kBK};
  const cuuint64_t o_dims[3] = {o4, (cuuint64_t)cv.n, (cuuint64_t)cv.batch * side - 2};
  const cuuint64_t o_strides[2] = {o4 * 2, side * o4 * 2};
  const cuuint32_t o_box[3] = {64, 64, 1};
  if (!encode(&prm.x_map, cv.x[0], 5, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&prm.b_map, cv.w[0], 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&prm.out_map, cv.out + (side + 1) * o4, 3, o_dims, o_strides, o_box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  switch (prm.plan.bn) {
    case 64: return launch_deconv<64>(prm, stream);
    case 128: return launch_deconv<128>(prm, stream);
    case 192: return launch_deconv<192>(prm, stream);
    case 256: return launch_deconv<256>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace depgan

// K4's plan as the kernel takes it: out[0..15] = bn, n_blocks, wrow, steps,
// halves, kt, a_row, a_stages, b_bytes, bufs, smem, then the A box (32, 2,
// 1, m, 1). Returns the number of ints written, or -1 for widths the kernel
// refuses or if they would not fit in cap.
extern "C" int depgan_deconv_plan(int m, int c4, int o4, int* out, int cap) {
  using namespace depgan::wg;
  const DeconvPlan p = deconv_plan(m, c4, o4);
  if (p.bn == 0) return -1;
  const int all[16] = {p.bn,     p.n_blocks, p.wrow, p.steps, p.halves, p.kt, p.a_row, p.a_stages,
                       p.b_bytes, p.bufs,    p.smem, kHalf,   2,        1,    m,       1};
  if (cap < 16) return -1;
  for (int k = 0; k < 16; ++k) out[k] = all[k];
  return 16;
}
