// K11 in bf16 for Hopper (sm_90a): the packed 5x5 conv as a window of input
// rows on the wgmma machinery of K7 (wgmma_device.cuh), kernel conv5_wgmma;
// the design is Conv5Window in s2d_wgmma.cuh.
//
// Replaces, in bf16, _conv5_impl with _kernel5_packed
// (depgan_tpu/ops/conv_s2d_pallas.py :1940, kernel :1889), which
// CONV5_PACKED selects for 4C <= 64: K7's function, relu or none
// (conv5x5_SAME(x, w5) + b over the padded unshifted s2d plane, as one
// K = 9 4C deep product). The Pallas kernel stages the 9 taps once,
// lane-concatenated, and runs one wide matmul a strip. float32 K11 stays
// on window_conv (window_kernels.cu), and so does bf16 as the old route
// that chip_smoke.py times beside this one.
//
// Bound: at the critic's shapes (n 128 and 64, 4C 16 and 64, 4Co 16 to 128)
// the product is 40-140 FLOP per byte of its bf16 planes, under the H100's
// ridge, so the planes' traffic bounds it. K7 on the mainloop loads each
// 256-row tile's 9 taps as TMA boxes, ~9 reads of every input row from L2
// (~5 TB/s of boxes at L0b). Here a tile's rows + 2 input rows arrive once,
// as one TMA box an 8-channel chunk, into a window that wgmma reads through
// a non-swizzled descriptor: a tap's shift is an address, and each input
// row is read (rows + 2) / rows times, 2x at n 128 and 1.5x at n 64. One
// persistent block an SM walks K1's tiles; the producer thread loads the
// next tile's window into the second one while the consumers multiply.
// B, the 9 4C x 4Co weight rows, is loaded once a block where it fits
// beside the windows (at 4Co <= 64: 74 KB at 4C 64) and read by every
// tile, else streamed through a ring of B stages as the mainloop does. Each
// output sums its 16-deep steps in K7's order and skips the steps past K,
// so K11 equals K7 bit for bit.

#include "wgmma_device.cuh"

namespace depgan {
namespace wg {
namespace {

struct alignas(64) Conv5Params {
  CUtensorMap x_map;  // the plane as (4C, P, P, B), box (8, n + 2, rows + 2, 1), no swizzle
  CUtensorMap b_map;  // the weights as (co4, 9 4C), box (64, 64), 128-byte swizzle
  Conv conv;
  Conv5Window win;
  int tiles_img;  // tiles an image: n / rows rounded up
};

// Tile i of the walk is output rows y0 .. y0 + rows - 1 of image b; m64
// tile g MT + mt of a consumer is output row (64 (g MT + mt)) / wrow at
// pixel (64 (g MT + mt)) % wrow. Rows past n read the window's zero rows
// (TMA fills what lies past the plane), pixels past n the next row or the
// pad; neither is stored.
template <int BN, int MT>
__global__ void __launch_bounds__(kThreadsWg, 1) conv5_wgmma(const __grid_constant__ Conv5Params p) {
  constexpr int kBStage = BN * kBK * 2, kSteps = kBK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full_b[kStages], empty_b[kStages], full_w[2], empty_w[2];

  const Conv& cv = p.conv;
  const Conv5Window& w = p.win;
  const int tid = threadIdx.x, n = cv.n, side = n + 2, c4 = cv.c4[0], co4 = cv.co4;
  unsigned char* win = smem + w.b_stages * kBStage;
  // The step plan: of each 16-deep step, its window offset from the m64
  // tile's first pixel at tap (0, 0): chunk, then dy rows and dx pixels.
  int* plan = reinterpret_cast<int*>(win + w.w_stages * w.win_bytes);
  for (int i = tid; i < w.w_stages * w.win_bytes / 16; i += kThreadsWg)
    reinterpret_cast<uint4*>(win)[i] = make_uint4(0, 0, 0, 0);  // the pads stay zero
  fence_proxy_async();  // ... before TMA writes the same bytes
  for (int j = tid; j < w.steps; j += kThreadsWg) {
    const Chunk ck = chunk(kGatherConv5x5, c4, j * 16);
    plan[j] = ck.c / 8 * w.lead + (ck.dy * w.pitch + ck.dx) * 16;
  }
  if (tid == 0) {
    for (int s = 0; s < w.b_stages; ++s) mbar_init(&full_b[s], 1), mbar_init(&empty_b[s], 8);
    for (int s = 0; s < w.w_stages; ++s) mbar_init(&full_w[s], 1), mbar_init(&empty_w[s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_ring(cv.out, cv.batch, side, co4, (int64_t)blockIdx.x * kThreadsWg + tid,
            (int64_t)gridDim.x * kThreadsWg);
  __syncthreads();
  const int64_t tiles = (int64_t)cv.batch * p.tiles_img;

  if (tid < 128) {  // the producer warpgroup: one thread issues every box
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tid != 0) return;
    const uint32_t win_tx = (uint32_t)c4 * side * (w.rows + 2) * 2;
    int wi = 0, bt = 0;  // windows loaded, B stages loaded
    if (w.resident) {  // all of B once, on one barrier: stage t holds k-tile t
      mbar_expect_tx(&full_b[0], w.kt * kBStage);
      for (int t = 0; t < w.kt; ++t)
#pragma unroll
        for (int j = 0; j < BN / kBBox; ++j)
          tma_2d(smem + t * kBStage + j * kBBoxBytes, &p.b_map, &full_b[0], j * kBBox, t * kBK);
    }
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++wi) {
      const int b = (int)(tile / p.tiles_img), y0 = (int)(tile % p.tiles_img) * w.rows;
      const int ws = wi % w.w_stages;
      if (wi >= w.w_stages) mbar_wait(&empty_w[ws], (wi / w.w_stages - 1) & 1);
      mbar_expect_tx(&full_w[ws], win_tx);
      for (int k8 = 0; k8 < c4 / 8; ++k8)  // padded rows y0 .. y0 + rows + 1 of chunk k8
        tma_4d(win + ws * w.win_bytes + k8 * w.lead, &p.x_map, &full_w[ws], k8 * 8, 0, y0, b);
      for (int t = 0; t < w.kt && !w.resident; ++t, ++bt) {
        const int s = bt % w.b_stages;
        if (bt >= w.b_stages) mbar_wait(&empty_b[s], (bt / w.b_stages - 1) & 1);
        mbar_expect_tx(&full_b[s], kBStage);
#pragma unroll
        for (int j = 0; j < BN / kBBox; ++j)
          tma_2d(smem + s * kBStage + j * kBBoxBytes, &p.b_map, &full_b[s], j * kBBox, t * kBK);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31, q = lane & 3;
  const uint32_t win0 = smem_u32(win), b0 = smem_u32(smem);
  int wi = 0, bt = 0;  // windows consumed, B stages consumed
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++wi) {
    const int b = (int)(tile / p.tiles_img), y0 = (int)(tile % p.tiles_img) * w.rows;
    const int ws = wi % w.w_stages;
    mbar_wait(&full_w[ws], (wi / w.w_stages) & 1);
    uint32_t abase[MT];  // each m64 tile's A at tap (0, 0): its row, its first pixel
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int i64 = (g * MT + mt) * 64;
      abase[mt] = win0 + ws * w.win_bytes + (i64 / w.wrow * w.pitch + i64 % w.wrow) * 16;
    }
    float acc[MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[mt][e] = 0.f;
    if (w.resident) mbar_wait(&full_b[0], 0);  // kept B: a wait that returns after the first tile
    for (int t = 0; t < w.kt; ++t) {
      const int s = w.resident ? t : bt % w.b_stages;
      if (!w.resident) mbar_wait(&full_b[s], (bt++ / w.b_stages) & 1);
      const uint32_t bs = b0 + s * kBStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (t * kSteps + kk >= w.steps) break;  // past K: B's rows there are zeros, skipped
        const int e = plan[t * kSteps + kk];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          Wgmma<BN>::mma(acc[mt], desc_window(abase[mt] + e, w.lead), desc_b(bs + kk * 16 * 128));
      }
      wgmma_commit();
      if (t > 0 && !w.resident) {  // the previous streamed stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty_b[(bt - 2) % w.b_stages]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) {  // the last B stage and the window: the next tile's loads may go there
      if (!w.resident) mbar_arrive(&empty_b[(bt - 1) % w.b_stages]);
      mbar_arrive(&empty_w[ws]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) pin(acc[mt][e]);

    // K7's epilogue; rows past the plane and pixels past n are not stored.
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi) {
      const int mt = mi / 2, i = mi % 2, i64 = (g * MT + mt) * 64;
      const int y = y0 + i64 / w.wrow, x = i64 % w.wrow + warp * 16 + (lane >> 2) + 8 * i;
      const bool live = y < n && x < n;
      const int64_t pos = ((int64_t)b * side + y + 1) * side + x + 1;
#pragma unroll
      for (int G = 0; G < BN / 32; ++G) {
        float v[8];
        quad_columns<BN>(acc[mt], G, i, q, lane, v);
        const int col = 8 * (4 * G + q);
        if (!live || col >= co4) continue;
        add_bias(cv.bias, col, v);
        if (cv.epilogue == kRelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        }
        store_bf16(cv.out + pos * co4 + col, v);
      }
    }
  }
}

template <int BN, int MT>
cudaError_t launch_conv5(const Conv5Params& prm, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      conv5_wgmma<BN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, prm.win.smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)prm.conv.batch * prm.tiles_img;
  conv5_wgmma<BN, MT><<<(unsigned)(tiles < sms ? tiles : sms), kThreadsWg, prm.win.smem,
                        stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

cudaError_t conv5_window_conv(const Conv& cv, cudaStream_t stream) {
  Conv5Params prm{};
  prm.win = conv5_window(cv.n, cv.c4[0], cv.co4);
  if (prm.win.bm == 0 || cv.batch <= 0 || cv.gather != kGatherConv5x5 || cv.n_ops != 1 ||
      cv.pool != kPoolNone || (cv.epilogue != kRelu && cv.epilogue != kNone))
    return cudaErrorInvalidValue;
  prm.conv = cv;
  prm.tiles_img = (cv.n + prm.win.rows - 1) / prm.win.rows;
  const cuuint64_t side = cv.n + 2, c4 = cv.c4[0];
  const cuuint64_t w_dims[2] = {(cuuint64_t)cv.co4, 9 * c4};  // past K and 4Co: zeros
  const cuuint64_t w_strides[1] = {(cuuint64_t)cv.co4 * 2};
  const cuuint32_t w_box[2] = {kBBox, kBK};
  const cuuint64_t x_dims[4] = {c4, side, side, (cuuint64_t)cv.batch};
  const cuuint64_t x_strides[3] = {c4 * 2, side * c4 * 2, side * side * c4 * 2};
  const cuuint32_t x_box[4] = {kVec, (cuuint32_t)side, (cuuint32_t)prm.win.rows + 2, 1};
  if (!encode(&prm.b_map, cv.w[0], 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&prm.x_map, cv.x[0], 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  switch (prm.win.bn) {
    case 64: return launch_conv5<64, 2>(prm, stream);
    case 128: return launch_conv5<128, 2>(prm, stream);
    case 192: return launch_conv5<192, 1>(prm, stream);
    case 256: return launch_conv5<256, 1>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace depgan

// K11 in bf16 over the window: w9 (9*c4, co4) rows of the transformed 5x5
// kernel; epilogue 0 = relu, 2 = none. Takes what conv5_window takes.
extern "C" int depgan_conv5x5_s2d_window(const void* x, const void* w9, const void* bias,
                                         void* out, int batch, int n, int c4, int co4,
                                         int epilogue, void* stream) {
  using namespace depgan;
  wg::Conv cv{};
  cv.x[0] = static_cast<const __nv_bfloat16*>(x);
  cv.w[0] = static_cast<const __nv_bfloat16*>(w9);
  cv.c4[0] = c4;
  cv.gather = kGatherConv5x5, cv.n_ops = 1, cv.batch = batch, cv.n = n, cv.co4 = co4;
  cv.epilogue = epilogue, cv.pool = kPoolNone;
  cv.bias = static_cast<const float*>(bias);
  cv.out = static_cast<__nv_bfloat16*>(out);
  return wg::conv5_window_conv(cv, static_cast<cudaStream_t>(stream));
}

// K11's window as the kernel takes it: out[0..13] = bm, bn, mt, wrow, rows,
// pitch, lead, win_bytes, w_stages, b_stages, resident, steps, kt, smem;
// then, for each 16-deep step in k order, (channel, dx, dy): what it reads
// at window row +dy, pixel +dx. Returns the number of ints written, or -1
// for widths the kernel refuses or if they would not fit in cap.
extern "C" int depgan_conv5_window_plan(int n, int c4, int co4, int* out, int cap) {
  using namespace depgan::wg;
  const Conv5Window w = conv5_window(n, c4, co4);
  if (w.bm == 0) return -1;
  const int head[14] = {w.bm,       w.bn,    w.mt,        w.wrow,     w.rows,
                        w.pitch,    w.lead,  w.win_bytes, w.w_stages, w.b_stages,
                        w.resident, w.steps, w.kt,        w.smem};
  int k = 0;
  for (int v : head) {
    if (k >= cap) return -1;
    out[k++] = v;
  }
  for (int j = 0; j < w.steps; ++j) {
    if (k + 3 > cap) return -1;
    const Chunk ck = chunk(depgan::kGatherConv5x5, c4, j * 16);
    out[k++] = ck.c, out[k++] = ck.dx, out[k++] = ck.dy;
  }
  return k;
}
