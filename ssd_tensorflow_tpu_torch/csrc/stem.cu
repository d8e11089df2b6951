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
// Design: a persistent grid, one 256-thread block per SM. Each block
// holds conv1_2's 3x3x64x64 weights in shared memory for its whole life
// (81 KB) and walks output tiles of 16 conv rows x 32 conv columns
// (8 x 16 pooled pixels). Per tile it stages the 18 x 34 pixel halo of
// y1 in shared memory (86 KB, bias, ReLU, bf16 rounding and the zero
// border applied while staging), then runs conv1_2 + pool1 as the
// mma.sync implicit GEMM of stem_common.cuh, which csrc/stem_uint8.cu
// shares. This first version neither pipelines the halo loads against
// the MMAs nor uses wgmma/TMA; those are the next steps toward the bound.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr size_t kSmemBytes =
    (kHaloElems + kWeightElems) * sizeof(__nv_bfloat16) + 2 * kC * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const __nv_bfloat16* __restrict__ c1, const float* __restrict__ b1,
            const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
            __nv_bfloat16* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wts = halo + kHaloElems;
  float* sb1 = reinterpret_cast<float*>(wts + kWeightElems);
  float* sb2 = sb1 + kC;

  const int tid = threadIdx.x;
  load_conv1_2(wts, sb2, w2t, b2);
  if (tid < kC) sb1[tid] = b1[tid];

  const int tiles = tile_count(batch, h, w);
  const int ho = h / 2, wo = w / 2;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, h, w);

    __syncthreads();  // previous tile's MMAs are done with the halo
    for (int i = tid; i < kHaloR * kHaloC * 8; i += kThreads) {
      const int pix = i >> 3, v = i & 7;
      const int r = pix / kHaloC, cc = pix - r * kHaloC;
      const int gy = tl.y0 - 1 + r, gx = tl.x0 - 1 + cc;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const uint4 raw = reinterpret_cast<const uint4*>(
            c1 + ((static_cast<size_t>(tl.b) * h + gy) * w + gx) * kC)[v];
        const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(&raw);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(src[k]);
          const int ch = v * 8 + 2 * k;
          dst[k] = __floats2bfloat162_rn(fmaxf(f.x + sb1[ch], 0.0f),
                                         fmaxf(f.y + sb1[ch + 1], 0.0f));
        }
      }
      reinterpret_cast<uint4*>(halo + pix * kPix)[v] = packed;
    }
    __syncthreads();
    conv1_2_pool_store(halo, wts, sb2, out, tl, ho, wo);
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
