// Shared pieces of the VGG conv1 stem kernels for Hopper (sm_90a):
// csrc/stem.cu (conv1_2 + pool1 over conv1_1's output) and
// csrc/stem_uint8.cu (the whole stem from the raw uint8 image).
//
// Both kernels walk output tiles of 16 conv rows x 32 conv columns with
// one persistent 256-thread block per SM. A tile's conv1_1 activation y1
// (bias, ReLU, the zero border and the bf16 rounding already applied)
// is staged in shared memory as an 18 x 34 pixel halo of 64 channels,
// pixel rows padded to 72 bf16 so mma fragment reads are free of bank
// conflicts. conv1_2's 3x3x64x64 weights stay in shared memory for the
// block's life as [tap][cout][cin] rows of 72. conv1_2_pool_store runs
// conv1_2 over the halo as an implicit GEMM with mma.sync m16n8k16
// bf16 -> f32 (warp w owns conv rows 2w and 2w+1: four 16-pixel M tiles
// times eight 8-channel N tiles, K = 9 taps x 64 channels, 128 f32
// accumulators a thread), pools 2x2 in registers, adds b2, applies ReLU
// (max commutes with both) and stores bf16 pool1. Each kernel file
// stages the halo its own way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {

constexpr int kC = 64;                 // conv1_1 / conv1_2 channels out (conv1_2's in)
constexpr int kTileR = 16;             // conv rows per tile
constexpr int kTileC = 32;             // conv columns per tile
constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kPix = 72;               // padded bf16 stride of a pixel / weight row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHaloElems = kHaloR * kHaloC * kPix;
constexpr int kWeightElems = 9 * kC * kPix;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Tile {
  int b, y0, x0;  // image, first conv row, first conv column
};

__device__ __forceinline__ int tile_count(int batch, int h, int w) {
  return batch * ((h + kTileR - 1) / kTileR) * ((w + kTileC - 1) / kTileC);
}

__device__ __forceinline__ Tile tile_at(int tile, int h, int w) {
  const int tiles_y = (h + kTileR - 1) / kTileR;
  const int tiles_x = (w + kTileC - 1) / kTileC;
  const int b = tile / (tiles_y * tiles_x);
  const int rem = tile - b * tiles_y * tiles_x;
  return Tile{b, (rem / tiles_x) * kTileR, (rem % tiles_x) * kTileC};
}

// conv1_2's weights (9, 64, 64) bf16 [tap][cout][cin] into shared rows of
// kPix, and b2 into sb2. Called by every thread of the block once.
__device__ __forceinline__ void load_conv1_2(__nv_bfloat16* wts, float* sb2,
                                             const __nv_bfloat16* __restrict__ w2t,
                                             const float* __restrict__ b2) {
  for (int i = threadIdx.x; i < 9 * kC * 8; i += kThreads) {
    const int row = i >> 3, v = i & 7;
    reinterpret_cast<uint4*>(wts + row * kPix)[v] = reinterpret_cast<const uint4*>(w2t + row * kC)[v];
  }
  if (threadIdx.x < kC) sb2[threadIdx.x] = b2[threadIdx.x];
}

// conv1_2 + b2 + ReLU + 2x2/s2 max-pool of one tile over the staged halo,
// stored as bf16 pool1 (B, H/2, W/2, 64). The caller synchronises the
// block after staging the halo and before the next tile overwrites it.
__device__ __forceinline__ void conv1_2_pool_store(const __nv_bfloat16* halo,
                                                   const __nv_bfloat16* wts, const float* sb2,
                                                   __nv_bfloat16* __restrict__ out, Tile tl,
                                                   int ho, int wo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // M tile mt: conv row 2*warp + (mt >> 1), columns (mt & 1) * 16 + [0, 16)
        const int hr = 2 * warp + (mt >> 1) + dy;
        const int hc = (mt & 1) * 16 + g + dx;
        const __nv_bfloat16* p0 = halo + (hr * kHaloC + hc) * kPix + kc * 16 + 2 * t;
        const __nv_bfloat16* p1 = p0 + 8 * kPix;
        a[mt][0] = lds32(p0);
        a[mt][1] = lds32(p1);
        a[mt][2] = lds32(p0 + 8);
        a[mt][3] = lds32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* q = wts + (tap * kC + nt * 8 + g) * kPix + kc * 16 + 2 * t;
        const uint32_t bb0 = lds32(q), bb1 = lds32(q + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], bb0, bb1);
      }
    }
  }

  // 2x2 pool: rows 2*warp and 2*warp+1 are M tiles (half) and (half + 2)
  // of this thread; columns g and g^1 sit in lanes differing by 4.
  const int prow = tl.y0 / 2 + warp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float m = fmaxf(acc[half][nt][k], acc[half + 2][nt][k]);
        v[k] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      }
      // even g stores the pixel pair (g, g+1); odd g the pair (g+7, g+8)
      const int odd = g & 1;
      const int pcol = tl.x0 / 2 + half * 8 + (g >> 1) + 4 * odd;
      const int ch = nt * 8 + 2 * t;
      const float lo = odd ? v[2] : v[0];
      const float hi = odd ? v[3] : v[1];
      if (prow < ho && pcol < wo) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(tl.b) * ho + prow) * wo + pcol) * kC + ch) =
            __floats2bfloat162_rn(fmaxf(lo + sb2[ch], 0.0f), fmaxf(hi + sb2[ch + 1], 0.0f));
      }
    }
  }
}

// Opts `kernel` into `bytes` of dynamic shared memory on the current
// device. The attribute belongs to the function on each device, so each
// kernel keeps its own `allowed` flags and sets it once per device.
template <typename Kernel>
cudaError_t smem_opt_in(bool (&allowed)[kMaxDevices], Kernel* kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

}  // namespace stem
