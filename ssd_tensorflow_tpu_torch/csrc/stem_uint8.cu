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
// Design: csrc/stem.cu's persistent grid, tiles, shared-memory halo and
// conv1_2 + pool loop (stem_common.cuh). Only the halo staging differs:
// per tile the block reads the 20 x 36 pixel uint8 strip of the image
// that the 18 x 34 halo of conv1_1 outputs needs, preprocesses it into
// shared memory (4 KB), and runs conv1_1 on the tensor cores too: an
// implicit GEMM of M = 612 halo pixels (39 M tiles spread over the eight
// warps), N = 64, K = 27 (3x3 taps x 3 channels) padded to 32, i.e. two
// m16n8k16 steps per tile. The A fragments are gathered from the strip
// with per-thread offsets; b1, ReLU, the zero border and the bf16
// rounding run on the accumulators before the halo store. conv1_1 is
// 4.5 % of the FLOPs; on the CUDA cores its ~1.06 M FMAs per tile would
// cost about as long as conv1_2's MMAs. Shared memory: stem.cu's 167.6 KB
// + the strip and w1 (9.4 KB), under the 227 KB a block may take.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int kStripR = kHaloR + 2;              // 20 image rows
constexpr int kStripC = kHaloC + 2;              // 36 image columns
constexpr int kStripElems = kStripR * kStripC * 3;
constexpr int kK1 = 32;                          // conv1_1's K: 27 padded
constexpr int kW1Pix = 40;                       // padded row of w1 [cout][k]
constexpr int kHaloPix = kHaloR * kHaloC;        // 612
constexpr int kMTiles1 = (kHaloPix + 15) / 16;   // 39
constexpr size_t kSmemBytes =
    (kHaloElems + kWeightElems + kC * kW1Pix + kStripElems) * sizeof(__nv_bfloat16) +
    (2 * kC + 4) * sizeof(float);

static_assert((kStripElems * sizeof(__nv_bfloat16)) % 16 == 0, "strip keeps floats aligned");

__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__global__ void __launch_bounds__(kThreads, 1)
stem_uint8_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mean,
                  const __nv_bfloat16* __restrict__ w1k, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wts = halo + kHaloElems;
  __nv_bfloat16* w1s = wts + kWeightElems;
  __nv_bfloat16* strip = w1s + kC * kW1Pix;
  float* sb1 = reinterpret_cast<float*>(strip + kStripElems);
  float* sb2 = sb1 + kC;
  float* smean = sb2 + kC;
  const unsigned short* strip16 = reinterpret_cast<const unsigned short*>(strip);

  const int tid = threadIdx.x;
  load_conv1_2(wts, sb2, w2t, b2);
  // w1k: (64, 32) bf16 [cout][k], k = (dy*3 + dx)*3 + c, zero for k >= 27
  for (int i = tid; i < kC * (kK1 / 8); i += kThreads) {
    const int row = i / (kK1 / 8), v = i % (kK1 / 8);
    reinterpret_cast<uint4*>(w1s + row * kW1Pix)[v] = reinterpret_cast<const uint4*>(w1k + row * kK1)[v];
  }
  if (tid < kC) sb1[tid] = b1[tid];
  if (tid < 3) smean[tid] = mean[tid];

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // The K columns of this thread's A fragments: step s, slot j holds
  // k = 16s + 2t + (j & 1) + 8 * (j >> 1). koff is k's offset in the strip
  // from a pixel's 3x3 window origin, -1 for the zero padding k >= 27.
  int koff[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * s + 2 * t + (j & 1) + 8 * (j >> 1);
      const int tap = k / 3, c = k - tap * 3;
      koff[s][j] = k < 27 ? ((tap / 3) * kStripC + tap % 3) * 3 + c : -1;
    }

  const int tiles = tile_count(batch, h, w);
  const int ho = h / 2, wo = w / 2;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, h, w);
    const uint8_t* im = img + static_cast<size_t>(tl.b) * h * w * 3;

    __syncthreads();  // previous tile's MMAs are done with the halo and strip
    // 1. image rows y0-2 .. y0+17, columns x0-2 .. x0+33: bf16(u8 - mean),
    //    zero outside the image
    for (int i = tid; i < kStripElems; i += kThreads) {
      const int r = i / (kStripC * 3);
      const int rem = i - r * (kStripC * 3);
      const int cc = rem / 3, c = rem - cc * 3;
      const int gy = tl.y0 - 2 + r, gx = tl.x0 - 2 + cc;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = static_cast<float>(im[(static_cast<size_t>(gy) * w + gx) * 3 + c]) - smean[c];
      strip[i] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // 2. conv1_1 of the 18 x 34 halo pixels: halo pixel (hr, hc) is image
    //    pixel (y0-1+hr, x0-1+hc); its 3x3 window starts at strip (hr, hc).
    for (int mt = warp; mt < kMTiles1; mt += kWarps) {
      int base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = mt * 16 + g + 8 * i;
        base[i] = p < kHaloPix ? ((p / kHaloC) * kStripC + p % kHaloC) * 3 : -1;
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        unsigned short e[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            e[i][j] = (base[i] >= 0 && koff[s][j] >= 0) ? strip16[base[i] + koff[s][j]] : 0;
        // a0: (row g, k0 k1), a1: (row g+8, k0 k1), a2: (row g, k2 k3), a3: (row g+8, k2 k3)
        const uint32_t a[4] = {pack_bf16(e[0][0], e[0][1]), pack_bf16(e[1][0], e[1][1]),
                               pack_bf16(e[0][2], e[0][3]), pack_bf16(e[1][2], e[1][3])};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* q = w1s + (nt * 8 + g) * kW1Pix + 16 * s + 2 * t;
          mma_bf16(acc[nt], a, lds32(q), lds32(q + 8));
        }
      }
      // + b1 on the float32 accumulator, ReLU, zero outside the image, one rounding
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = mt * 16 + g + 8 * i;
        if (p >= kHaloPix) continue;
        const int hr = p / kHaloC, hc = p - hr * kHaloC;
        const int gy = tl.y0 - 1 + hr, gx = tl.x0 - 1 + hc;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = nt * 8 + 2 * t;
          const float v0 = inside ? fmaxf(acc[nt][2 * i] + sb1[ch], 0.0f) : 0.0f;
          const float v1 = inside ? fmaxf(acc[nt][2 * i + 1] + sb1[ch + 1], 0.0f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(halo + p * kPix + ch) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();
    conv1_2_pool_store(halo, wts, sb2, out, tl, ho, wo);
  }
}

bool g_smem_allowed[kMaxDevices] = {};

}  // namespace

// img: (B, H, W, 3) uint8 NHWC; mean: (3,) float32 BGR means; w1k: (64, 32)
// bf16 [cout][(dy*3+dx)*3 + c], zero for k >= 27; b1, b2: (64,) float32;
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
