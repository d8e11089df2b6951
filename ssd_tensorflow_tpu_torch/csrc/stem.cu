// Fused conv1_2 + pool1 stem of VGG-16 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_tensorflow_tpu/ops/stem_pallas.py
// (_stem_kernel_dma, entry fused_stem_pallas_dma). Input is conv1_1's
// un-biased bf16 output c1 (B, H, W, 64) NHWC; per pixel the kernel
// computes y1 = bf16(relu(c1 + b1)), zero outside the image (conv1_2's
// SAME padding), then conv1_2 (3x3, 64 -> 64) with float32
// accumulation, + b2, ReLU, the 2x2/s2 max-pool, and stores bf16
// (B, H/2, W/2, 64). H and W must be even. The TPU kernel's width
// packing (two pixels in 128 lanes) is a TPU lane device and is not
// carried over.
//
// What bounds it on this card: operations. At the detection path's
// shape (B=64, 512x512) conv1_2 is 1.24 TFLOP against 2.7 GB of traffic
// (c1 read once, pool1 written once): ~1.25 ms at the bf16 tensor-core
// peak against ~0.8 ms at the memory rate. conv1_2's 2.1 GB activation
// never touches device memory, as on the TPU.
//
// Design: the warp-specialised persistent kernel of stem_common.cuh,
// which csrc/stem_uint8.cu shares: consumer warpgroups run conv1_2 on
// wgmma over two halo buffers and pool in registers; this file is the
// producer half. Its 256 producer threads stage a tile's 10 x 34
// pixel halo of y1: each thread owns one 16-byte channel chunk (so its 8
// values of b1 live in registers) of every 32nd halo pixel, starts all
// its 11 global loads before it touches the first result, so that a
// block keeps ~43 KB of loads in flight under the consumers' MMAs, then
// applies b1, ReLU, the rounding and the zero border in registers and
// stores 16 bytes to the padded halo. A TMA box load would land the raw
// c1 tile and need a second pass over it in shared memory for the bias,
// ReLU and border, on a shared-memory pipe the wgmma feeds already keep
// half busy; loads into registers need no such pass.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr size_t kSmemBytes = kCommonBytes;
constexpr int kChunksPerThread = (kHaloPix * 8 + kProducers - 1) / kProducers;  // 11

__device__ __forceinline__ void produce_tiles(unsigned char* smem,
                                              const __nv_bfloat16* __restrict__ c1, int batch,
                                              int h, int w) {
  const int pt = threadIdx.x - kConsumers;
  const int v = pt & 7, pix0 = pt >> 3;
  float b1v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b1v[k] = reinterpret_cast<const float*>(smem + kOffB1)[v * 8 + k];
  const int tiles = tile_count(batch, h, w);

  for (Walk wk; wk.tile < tiles; wk.next()) {
    const Tile tl = tile_at(wk.tile, h, w);
    const __nv_bfloat16* img = c1 + static_cast<size_t>(tl.b) * h * w * kC;

    uint4 raw[kChunksPerThread];
    uint32_t inside = 0;
#pragma unroll
    for (int k = 0; k < kChunksPerThread; ++k) {
      const int pix = pix0 + 32 * k;
      const int r = pix / kHaloC, cc = pix - r * kHaloC;
      const int gy = tl.y0 - 1 + r, gx = tl.x0 - 1 + cc;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (pix < kHaloPix && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        inside |= 1u << k;
        raw[k] = __ldg(reinterpret_cast<const uint4*>(img + (static_cast<size_t>(gy) * w + gx) * kC) + v);
      }
    }

    producer_acquire(smem, wk);
    unsigned char* halo = smem + kOffHalo + wk.stage * kHaloBytes;
#pragma unroll
    for (int k = 0; k < kChunksPerThread; ++k) {
      const int pix = pix0 + 32 * k;
      if (pix >= kHaloPix) break;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (inside & (1u << k)) {
        const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(src[q]);
          dst[q] = __floats2bfloat162_rn(fmaxf(f.x + b1v[2 * q], 0.0f),
                                         fmaxf(f.y + b1v[2 * q + 1], 0.0f));
        }
      }
      *reinterpret_cast<uint4*>(halo + (pix * kPix + v * 8) * 2) = packed;
    }
    producer_release(smem, wk);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const __nv_bfloat16* __restrict__ c1, const float* __restrict__ b1,
            const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
            __nv_bfloat16* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  block_setup(smem, w2t, b1, b2);
  if (threadIdx.x < kConsumers) {
    consumer_registers();
    consume_tiles(smem, out, batch, h, w);
  } else {
    producer_registers();
    produce_tiles(smem, c1, batch, h, w);
  }
}

bool g_smem_allowed[kMaxDevices] = {};

}  // namespace

// c1: (B, H, W, 64) bf16 NHWC; b1, b2: (64,) float32; w2t: (9, 64, 64) bf16
// as [dy*3+dx][cout][cin]; out: (B, H/2, W/2, 64) bf16. All contiguous,
// H and W even. `grid` persistent blocks. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int stem_launch(const void* c1, const float* b1, const void* w2t, const float* b2,
                           void* out, int batch, int h, int w, int grid, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = smem_opt_in(g_smem_allowed, stem_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(c1), b1, static_cast<const __nv_bfloat16*>(w2t), b2,
      static_cast<__nv_bfloat16*>(out), batch, h, w);
  return static_cast<int>(cudaGetLastError());
}
