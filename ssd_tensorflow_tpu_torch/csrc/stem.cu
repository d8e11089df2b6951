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
// (81 KB, [tap][cout][cin] rows padded to 72 so fragment reads are free
// of bank conflicts) and walks output tiles of 16 conv rows x 32 conv
// columns (8 x 16 pooled pixels). Per tile it stages the 18 x 34 pixel
// halo of y1 in shared memory (86 KB, bias, ReLU, bf16 rounding and the
// zero border applied while staging), then runs the conv as an implicit
// GEMM on the tensor cores with mma.sync m16n8k16 bf16 -> f32: warp w
// owns conv rows 2w and 2w+1 (four 16-pixel M tiles) times all 64 output
// channels (eight N tiles), K = 9 taps x 64 channels. The 2x2 pool runs
// in registers (rows within a thread, columns with one shuffle), then
// + b2 and ReLU (max commutes with both), and the bf16 store. This first
// version neither pipelines the halo loads against the MMAs nor uses
// wgmma/TMA; those are the next steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // channels in and out
constexpr int kTileR = 16;             // conv rows per tile
constexpr int kTileC = 32;             // conv columns per tile
constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kPix = 72;               // padded bf16 stride of a pixel / weight row
constexpr int kThreads = 256;
constexpr int kHaloElems = kHaloR * kHaloC * kPix;
constexpr int kWeightElems = 9 * kC * kPix;
constexpr size_t kSmemBytes =
    (kHaloElems + kWeightElems) * sizeof(__nv_bfloat16) + 2 * kC * sizeof(float);
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
  // weights: 9*64 rows of 64 bf16 = 8 vectors of 16 bytes each
  for (int i = tid; i < 9 * kC * 8; i += kThreads) {
    const int row = i >> 3, v = i & 7;
    reinterpret_cast<uint4*>(wts + row * kPix)[v] =
        reinterpret_cast<const uint4*>(w2t + row * kC)[v];
  }
  if (tid < kC) {
    sb1[tid] = b1[tid];
    sb2[tid] = b2[tid];
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_y = (h + kTileR - 1) / kTileR;
  const int tiles_x = (w + kTileC - 1) / kTileC;
  const int tiles = batch * tiles_y * tiles_x;
  const int ho = h / 2, wo = w / 2;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int y0 = (rem / tiles_x) * kTileR;
    const int x0 = (rem % tiles_x) * kTileC;

    __syncthreads();  // previous tile's MMAs are done with the halo
    for (int i = tid; i < kHaloR * kHaloC * 8; i += kThreads) {
      const int pix = i >> 3, v = i & 7;
      const int r = pix / kHaloC, cc = pix - r * kHaloC;
      const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const uint4 raw = reinterpret_cast<const uint4*>(
            c1 + ((static_cast<size_t>(b) * h + gy) * w + gx) * kC)[v];
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
    const int prow = y0 / 2 + warp;
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
        const int pcol = x0 / 2 + half * 8 + (g >> 1) + 4 * odd;
        const int ch = nt * 8 + 2 * t;
        const float lo = odd ? v[2] : v[0];
        const float hi = odd ? v[3] : v[1];
        if (prow < ho && pcol < wo) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((static_cast<size_t>(b) * ho + prow) * wo + pcol) * kC + ch) =
              __floats2bfloat162_rn(fmaxf(lo + sb2[ch], 0.0f), fmaxf(hi + sb2[ch + 1], 0.0f));
        }
      }
    }
  }
}

// Opts stem_kernel into kSmemBytes of dynamic shared memory on the
// current device. The attribute belongs to the function on each device,
// so it is set once per device, not on every launch.
cudaError_t allow_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

}  // namespace

// c1: (B, H, W, 64) bf16 NHWC; b1, b2: (64,) float32; w2t: (9, 64, 64) bf16
// as [dy*3+dx][cout][cin]; out: (B, H/2, W/2, 64) bf16. All contiguous,
// H and W even. `grid` persistent blocks. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int stem_launch(const void* c1, const float* b1, const void* w2t, const float* b2,
                           void* out, int batch, int h, int w, int grid, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(c1), b1, static_cast<const __nv_bfloat16*>(w2t), b2,
      static_cast<__nv_bfloat16*>(out), batch, h, w);
  return static_cast<int>(cudaGetLastError());
}
