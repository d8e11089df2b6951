// The whole VGG-16 stem from the raw uint8 image, for Hopper (sm_90a):
// preprocess + conv1_1 + ReLU + conv1_2 + ReLU + pool1 in one kernel.
//
// Replaces the Pallas TPU kernel ssd_tensorflow_tpu/ops/stem_pallas.py
// (_stem_kernel_uint8, entry fused_stem_uint8). Input is the raw BGR
// image (B, H, W, 3) uint8 NHWC; output bf16 pool1 (B, H/2, W/2, 64).
// H and W must be even. Per pixel, in the TPU kernel's order and with
// its rounding points:
//   1. x = bf16(u8 - mean) in float32, zero outside the image AFTER the
//      subtraction (conv1_1's SAME padding in preprocessed space);
//   2. conv1_1 (3x3, 3 -> 64) with float32 accumulation, + b1 on the
//      float32 accumulator, ReLU, then ONE bf16 rounding (the split stem
//      of csrc/stem.cu rounds the un-biased conv1_1 output first);
//   3. conv1_1 pixels outside the image are zero, not relu(b1)
//      (conv1_2's SAME padding);
//   4. conv1_2 (3x3, 64 -> 64) with float32 accumulation, + b2, ReLU, the
//      2x2/s2 max-pool, bf16 store.
// The TPU kernel's width packing (two pixels in 128 lanes, the
// lane-unflatten of the flat image strip, its K = 18 / K = 6 tap layouts)
// is a TPU lane device; all its layouts compute this one function.
//
// What bounds it on this card: operations. At the detection path's shape
// (B=64, 512x512) conv1_1 + conv1_2 are 1.295 TFLOP (1.31 ms at the bf16
// tensor-core peak) against 0.59 GB of traffic (the 50 MB image read
// once, the 537 MB pool1 written once; 0.18 ms). conv1_1's 2.1 GB
// activation and conv1_2's never touch device memory.
//
// Design: the warp-specialised persistent kernel of stem_common.cuh,
// which csrc/stem.cu shares: consumer warpgroups run conv1_2 on wgmma
// over two halo buffers and pool in registers; this file is the producer
// half, so conv1_1 runs off the consumers' critical path, into the next
// halo buffer while they work on the current one. Per tile of 8 x 32
// conv pixels the 256 producer threads read the 12 x 36 pixel uint8
// strip of the image that the 10 x 34 halo of conv1_1 outputs needs (the
// next tile's loads started before this tile's conv1_1) and preprocess it
// into shared memory as 4 bf16 a pixel: the three channels and a 1.0.
// conv1_1 runs on wgmma too, as an implicit GEMM of M = 340 halo pixels
// (six M tiles of 64, three per producer warpgroup), N = 64 and K = 48:
// K step dy is the 3x3 window's row dy, 4 pixels x 4 channels = 32
// contiguous bytes of the strip, so each A fragment register is one
// aligned 32-bit load (the fourth pixel meets zero weights). b1 rides on
// the channel of ones as three bf16 terms whose sum is b1 exactly, so it
// joins the float32 accumulator inside the MMA; ReLU, the zero border
// and the bf16 rounding run on the accumulators before the halo store.
// Two earlier producers were measured and dropped: conv1_1 on mma.sync
// (its HMMAs queue behind the consumers' wgmmas on the same tensor
// cores) and a K = 27 layout gathered with 16-bit loads (three times the
// instructions); both left the kernel producer-bound near 2.9 ms.
// Shared memory: the common 168 KB (weights 72 KB, two halos of 47.8 KB)
// + w1 (8 KB: 96 B used of each 128-byte swizzled row) and the strip
// (3.4 KB).

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int kStripR = kHaloR + 2;              // 12 image rows
constexpr int kStripC = kHaloC + 2;              // 36 image columns
constexpr int kStripPix = kStripR * kStripC;     // 432, of 4 bf16 (8 B) each
constexpr int kStripRowBytes = kStripC * 8;
constexpr int kK1 = 48;                          // conv1_1's K: 3 dy x (4 dx x 4 c)
constexpr int kMTiles1 = (kHaloPix + 63) / 64;   // 6 M tiles of 64 halo pixels
constexpr int kMTilesPerGroup = kMTiles1 / 2;    // per producer warpgroup
constexpr int kPixPerThread = (kStripPix + kProducers - 1) / kProducers;  // 2
constexpr int kOffW1 = (kCommonBytes + 1023) / 1024 * 1024;  // a swizzle atom's alignment
constexpr int kOffStrip = kOffW1 + kC * 128;
constexpr int kOffMean = kOffStrip + (kStripPix + 1) * 8;  // one pixel of slack, see gather
constexpr size_t kSmemBytes = kOffMean + 4 * sizeof(float);

static_assert(kMTiles1 % 2 == 0 && kOffStrip % 16 == 0 && kOffMean % 4 == 0, "aligned pieces");
static_assert(kSmemBytes <= 232448, "a block may take 227 KB of shared memory");

__device__ __forceinline__ void produce_tiles(unsigned char* smem,
                                              const uint8_t* __restrict__ img, int batch, int h,
                                              int w) {
  const int pt = threadIdx.x - kConsumers;
  const int group = pt >> 7, wi = (pt >> 5) & 3, lane = pt & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* strip = smem + kOffStrip;
  const float* smean = reinterpret_cast<const float*>(smem + kOffMean);
  const uint64_t desc_w1 = desc_sw128(smem_u32(smem + kOffW1));
  const float mean_c[3] = {smean[0], smean[1], smean[2]};
  if (pt == 0) *reinterpret_cast<uint2*>(strip + kStripPix * 8) = make_uint2(0u, 0u);  // the slack

  // image rows y0-2 .. y0+9, columns x0-2 .. x0+33 of a tile: this
  // thread's strip pixels as raw bytes b | g << 8 | r << 16 (bit k of
  // `inside`: pixel k is in the image), left untouched until the strip is
  // written
  uint32_t raw[kPixPerThread], inside = 0;
  auto load_strip = [&](int tile) {
    const Tile tl = tile_at(tile, h, w);
    const uint8_t* im = img + static_cast<size_t>(tl.b) * h * w * 3;
    inside = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const int i = pt + k * kProducers;
      const int r = i / kStripC, cc = i - r * kStripC;
      const int gy = tl.y0 - 2 + r, gx = tl.x0 - 2 + cc;
      raw[k] = 0;
      if (i < kStripPix && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        inside |= 1u << k;
        const uint8_t* px = im + (static_cast<size_t>(gy) * w + gx) * 3;
        raw[k] = __ldg(px) | (__ldg(px + 1) << 8) | (__ldg(px + 2) << 16);
      }
    }
  };

  const int tiles = tile_count(batch, h, w);
  if (blockIdx.x < tiles) load_strip(blockIdx.x);
  for (Walk wk; wk.tile < tiles; wk.next()) {
    const Tile tl = tile_at(wk.tile, h, w);

    // 1. the strip: per pixel bf16(u8 - mean) in float32 (zero outside the
    //    image) and a fourth channel of 1.0, which carries b1 into the MMA;
    //    the next tile's loads then fly under this tile's conv1_1
    producer_sync();  // every producer warp is done with the previous strip
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const int i = pt + k * kProducers;
      const bool in = (inside >> k) & 1u;
      const float x0 = in ? static_cast<float>(raw[k] & 255u) - mean_c[0] : 0.0f;
      const float x1 = in ? static_cast<float>((raw[k] >> 8) & 255u) - mean_c[1] : 0.0f;
      const float x2 = in ? static_cast<float>(raw[k] >> 16) - mean_c[2] : 0.0f;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x0, x1), hi = __floats2bfloat162_rn(x2, 1.0f);
      if (i < kStripPix)
        *reinterpret_cast<uint2*>(strip + i * 8) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
    producer_sync();
    if (wk.tile + static_cast<int>(gridDim.x) < tiles) load_strip(wk.tile + gridDim.x);

    // 2. conv1_1 of the 10 x 34 halo pixels on wgmma: halo pixel (hr, hc) is
    //    image pixel (y0-1+hr, x0-1+hc); its 3x3 window starts at strip
    //    (hr, hc). K step dy is that window's row: 4 pixels x 4 channels =
    //    32 contiguous bytes of the strip (the fourth pixel and, but for the
    //    bias slots, the fourth channel meet zero weights), so a fragment
    //    register is one aligned 32-bit load. M tile mt is halo pixels
    //    64 mt + [0, 64), this warp's 16 rows of it from 16 wi on; the two
    //    producer warpgroups take M tiles in turn.
    producer_acquire(smem, wk);
    __nv_bfloat16* halo =
        reinterpret_cast<__nv_bfloat16*>(smem + kOffHalo + wk.stage * kHaloBytes);
#pragma unroll 1
    for (int mt = group; mt < kMTiles1; mt += 2) {
      // rows past the halo's end read pixel 339's window and are not stored
      const unsigned char* row[2];
      int p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = mt * 64 + wi * 16 + g + 8 * i;
        const int q = min(p[i], kHaloPix - 1);
        row[i] = strip + ((q / kHaloC) * kStripC + q % kHaloC) * 8 + 4 * t;
      }
      // a0: (row g, k 2t 2t+1), a1: (row g+8, same k), a2 / a3: the same at k + 8.
      // The last halo pixel's third K step reads 8 B past the strip: the slack.
      uint32_t a[3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        a[dy][0] = *reinterpret_cast<const uint32_t*>(row[0] + dy * kStripRowBytes);
        a[dy][1] = *reinterpret_cast<const uint32_t*>(row[1] + dy * kStripRowBytes);
        a[dy][2] = *reinterpret_cast<const uint32_t*>(row[0] + dy * kStripRowBytes + 16);
        a[dy][3] = *reinterpret_cast<const uint32_t*>(row[1] + dy * kStripRowBytes + 16);
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) wgmma_m64n64k16(acc, a[dy], desc_w1 + ((dy * 32) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) keep(a[dy]);
      keep(acc);
      // b1 came in through the MMA; ReLU, zero outside the image, one rounding
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (p[i] >= kHaloPix) continue;
        const int hr = p[i] / kHaloC, hc = p[i] - hr * kHaloC;
        const int gy = tl.y0 - 1 + hr, gx = tl.x0 - 1 + hc;
        const bool in_image = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float v0 = in_image ? fmaxf(acc[4 * nt + 2 * i], 0.0f) : 0.0f;
          const float v1 = in_image ? fmaxf(acc[4 * nt + 2 * i + 1], 0.0f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(halo + p[i] * kPix + nt * 8 + 2 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    producer_release(smem, wk);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stem_uint8_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mean,
                  const __nv_bfloat16* __restrict__ w1k, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  // w1k: (64, 48) bf16 [cout][k] (see the launch function) into the first
  // 96 B of 128-byte rows in the 128-byte swizzle: conv1_1's B operand
  for (int i = tid; i < kC * (kK1 / 8); i += kThreads) {
    const int row = i / (kK1 / 8), c = i % (kK1 / 8);
    *reinterpret_cast<uint4*>(smem + kOffW1 + row * 128 + ((c ^ (row & 7)) << 4)) =
        reinterpret_cast<const uint4*>(w1k + row * kK1)[c];
  }
  if (tid < 3) reinterpret_cast<float*>(smem + kOffMean)[tid] = mean[tid];
  block_setup(smem, w2t, b1, b2);
  if (tid < kConsumers) {
    consumer_registers();
    consume_tiles(smem, out, batch, h, w);
  } else {
    producer_registers();
    produce_tiles(smem, img, batch, h, w);
  }
}

bool g_smem_allowed[kMaxDevices] = {};

}  // namespace
// img: (B, H, W, 3) uint8 NHWC; mean: (3,) float32 BGR means; w1k: (64, 48)
// bf16 [cout][dy*16 + dx*4 + c] with conv1_1's weights at dx, c < 3, b1 split
// into three bf16 terms at c = 3 of dx = 0 (k = 3, 19, 35) and zero
// elsewhere; b1 (unused: it is in w1k), b2: (64,) float32;
// w2t: (9, 64, 64) bf16 [dy*3+dx][cout][cin]; out: (B, H/2, W/2, 64) bf16.
// All contiguous, H and W even. `grid` persistent blocks. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int stem_uint8_launch(const void* img, const float* mean, const void* w1k,
                                 const float* b1, const void* w2t, const float* b2, void* out,
                                 int batch, int h, int w, int grid, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = smem_opt_in(g_smem_allowed, stem_uint8_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_uint8_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), mean, static_cast<const __nv_bfloat16*>(w1k), b1,
      static_cast<const __nv_bfloat16*>(w2t), b2, static_cast<__nv_bfloat16*>(out), batch, h, w);
  return static_cast<int>(cudaGetLastError());
}
