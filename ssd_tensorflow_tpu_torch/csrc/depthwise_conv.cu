// Depthwise 3x3 convolution of NHWC bf16 maps, MobileNetV1's 13 `*_dw`
// convs, in one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's depthwise conv is XLA's
// (ssd_tensorflow_tpu/models/layers.py, depthwise_conv2d). Before this
// kernel the card ran models/layers.depthwise_conv2d as up to five passes
// a conv: the TF SAME pad of a stride-2 input through F.pad, the bf16 map
// cast to float32 (which writes twice the bytes it reads), cuDNN's float32
// stencil, the cast back to bf16, and the bias added in a bf16 pass.
//
// Input x: NHWC (B, H, W, C) bf16, contiguous, C a multiple of 8; filter
// w: (C, 1, 3, 3) bf16, contiguous; stride 1 or 2; padding (top, left)
// with the output size (Ho, Wo), any bottom and right padding following
// from them. Each output is, bit for bit as ops/depthwise_cuda.
// depthwise_plain computes it:
//   1. acc = 0, then acc = acc + x[iy][ix] * w[ky][kx] in float32 for the
//      taps in the order ky, then kx; a tap outside the map adds nothing
//      (its product would be a zero). A bf16 x bf16 product is exact in
//      float32 (8 + 8 significant bits), so the fused multiply-add rounds
//      as the multiply then add does, for every product above float32's
//      smallest normal number;
//   2. the epilogue: no bias: bf16(acc); a float32 bias (the float
//      inference route's one rounding): bf16(acc + b); a bf16 bias (the
//      int8 route's weight-only form, two roundings): bf16(float32(
//      bf16(acc)) + float32(b)).
//
// What bounds it on this card: bytes. Nine multiply-adds an output element
// against 2 bytes read (4 read at stride 2) and 2 written. At batch 64 the
// 13 convs of mobilenet320 read and write ~1.30 GB of bf16: 0.39 ms at
// 3.35 TB/s, against ~4.1 ms for the five passes.
//
// Design: a persistent grid walks output tiles of th rows x tw columns x
// vs 16-byte vectors of channels (vs * 8 channels, up to 64) of one image.
// A tile's input, its halo included ((th - 1) * s + 3 rows x (tw - 1) * s
// + 3 columns x vs vectors, at most kTileBytes), lands in shared memory in
// one TMA copy of a 4-d box (channels, columns, rows, image) whose parts
// outside the map the copy engine fills with zeros: that is the padding,
// symmetric or not, with no padded copy and no per-element test. Two
// stages: one thread asks for tile i + 1 before the block computes tile i,
// so the copy engine streams under the arithmetic. Each thread owns one
// vector of channels for the block's whole life (the grid is a multiple of
// the slices, so a block always sees the same slice) and keeps that
// vector's 9 taps in 72 float32 registers, read once; it computes outputs
// of the tile from nine 16-byte shared-memory reads each and writes each
// with one 16-byte store, neighbouring threads on neighbouring vectors.
// Tiles are sized per call: rows and columns split evenly, as many rows
// as the stage holds, so that the shapes from 160x160x32 down to
// 10x10x1024 all give a thousand tiles or more at batch 64 and a
// halo of an eighth to two fifths of the tile; its re-reads come from L2.
//
// Measured on an H100 80GB HBM3 (700 W) at b64: 0.530 ms for mobilenet320's
// 13 convs against the 0.389 ms bound (73 %), 76-86 % at the 160x160 and
// 80x80 maps, 52-62 % at 20x20 and 10x10, where a block walks only a few
// tiles and the first copy's latency is not hidden; the five passes took
// 4.37 ms. ptxas: 123-128 registers, no spills, two blocks an SM.

#include <cuda.h>

#include "stem_common.cuh"

namespace {

using stem::mbar_init;
using stem::mbar_wait;
using stem::smem_u32;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;          // vectors of a slice: 64 channels, a 128-byte line
constexpr int kTileBytes = 49152;   // a stage: one tile's input with its halo
constexpr int kStageAlign = 128;
constexpr int kColsS1 = 32;         // the most output columns a tile takes at stride 1
constexpr int kColsS2 = 16;         // and at stride 2 (the same input width)

enum Epilogue { kRound = 0, kBiasF32 = 1, kBiasBf16 = 2 };

struct Params {
  const __nv_bfloat16* w;   // (C, 9)
  const void* bias;         // (C,) float32 (kBiasF32) or bf16 (kBiasBf16); else unused
  __nv_bfloat16* out;       // (B, Ho, Wo, C)
  int c, ho, wo, stride, pad_top, pad_left;
  int vs, lg_vs, slices;    // vectors of a slice, log2 of it, slices of C
  int th, tw, ih, iw;       // a tile's output rows and columns, input rows and columns
  int tiles_x, tiles_y;
  int tiles;                // B * tiles_y * tiles_x * slices
  int stage_bytes;          // a stage in shared memory, aligned
  int box_bytes;            // what one stage's copy delivers
};

__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The box of `map` at (c, x, y, b) (elements; negative or past the end
// reads zeros) to shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(bar)
      : "memory");
}

struct Tile {
  int b, ty, tx, slice;
};

// Tiles in the order (image, tile row, tile column, slice), slices fastest.
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile tl;
  tl.slice = t % p.slices;
  t /= p.slices;
  tl.tx = t % p.tiles_x;
  t /= p.tiles_x;
  tl.ty = t % p.tiles_y;
  tl.b = t / p.tiles_y;
  return tl;
}

// One thread asks for tile `t`'s input (with its halo) in stage `dst`.
__device__ __forceinline__ void stage_tile(const Params& p, const CUtensorMap* map, int t,
                                           uint32_t dst, uint32_t bar) {
  const Tile tl = tile_at(p, t);
  expect_tx(bar, p.box_bytes);
  tma_load_4d(dst, map, bar, tl.slice * p.vs * 8, tl.tx * p.tw * p.stride - p.pad_left,
              tl.ty * p.th * p.stride - p.pad_top, tl.b);
}

// Eight bf16 values (one 16-byte vector) as float32.
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    depthwise3x3_nhwc(const __grid_constant__ CUtensorMap xmap, const Params p) {
  extern __shared__ __align__(kStageAlign) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t bars = smem_u32(smem);   // full[2], 8 bytes each
  const uint32_t stage0 = bars + kStageAlign;
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && static_cast<int>(blockIdx.x) < p.tiles) {
    stage_tile(p, &xmap, blockIdx.x, stage0, bars);
  }

  // This thread's vector of channels: the same in every tile of the block
  // (gridDim.x is a multiple of p.slices and kThreads of p.vs).
  const int v = tid & (p.vs - 1);
  const int c0 = ((blockIdx.x % p.slices) * p.vs + v) * 8;
  float wf[9][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int k = 0; k < 9; ++k) wf[k][j] = __bfloat162float(p.w[(c0 + j) * 9 + k]);
  }
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (kEpi == kBiasF32) {
      bias[j] = static_cast<const float*>(p.bias)[c0 + j];
    } else if constexpr (kEpi == kBiasBf16) {
      bias[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[c0 + j]);
    } else {
      bias[j] = 0.0f;
    }
  }

  const int pitch = p.vs * 16;            // bytes of a staged input pixel
  const int row_step = p.iw * pitch;      // bytes of a staged input row
  int i = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++i) {
    const int s = i & 1;
    const int next = t + gridDim.x;
    // stage s ^ 1 was last read in step i - 1, which every thread has left
    if (tid == 0 && next < p.tiles) {
      stage_tile(p, &xmap, next, stage0 + (s ^ 1) * p.stage_bytes, bars + 8 * (s ^ 1));
    }
    const Tile tl = tile_at(p, t);
    const int oy0 = tl.ty * p.th, ox0 = tl.tx * p.tw;
    const int rows = min(p.th, p.ho - oy0), cols = min(p.tw, p.wo - ox0);
    const int per_row = cols << p.lg_vs;   // outputs (vectors) of a tile row
    mbar_wait(bars + 8 * s, (i >> 1) & 1);
    const unsigned char* tile = smem + kStageAlign + s * p.stage_bytes;
    __nv_bfloat16* out = p.out + static_cast<long long>(tl.b) * p.ho * p.wo * p.c + c0;
    int r = tid / per_row, q = tid - r * per_row;
    while (r < rows) {
      const int col = q >> p.lg_vs;
      const unsigned char* at = tile + (r * p.stride) * row_step + (col * p.stride) * pitch + v * 16;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float xf[8];
          unpack(*reinterpret_cast<const uint4*>(at + ky * row_step + kx * pitch), xf);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(xf[j], wf[ky * 3 + kx][j], acc[j]);
        }
      }
      uint4 y;
      uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float lo = acc[2 * k], hi = acc[2 * k + 1];
        if constexpr (kEpi == kBiasF32) {
          lo = __fadd_rn(lo, bias[2 * k]);
          hi = __fadd_rn(hi, bias[2 * k + 1]);
        } else if constexpr (kEpi == kBiasBf16) {
          const float2 rounded = __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
          lo = __fadd_rn(rounded.x, bias[2 * k]);
          hi = __fadd_rn(rounded.y, bias[2 * k + 1]);
        }
        yw[k] = pack(lo, hi);
      }
      const long long pix = static_cast<long long>(oy0 + r) * p.wo + ox0 + col;
      *reinterpret_cast<uint4*>(out + pix * p.c) = y;
      q += kThreads;
      while (q >= per_row) {
        q -= per_row;
        ++r;
      }
    }
    __syncthreads();  // every thread has read stage s before step i + 1 refills it
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of the NHWC input whose box is one tile's input:
// vs * 8 channels x iw columns x ih rows x 1 image, zeros outside.
cudaError_t input_map(const void* x, int batch, int h, int w, const Params& p, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.c) * 2,
                                 static_cast<cuuint64_t>(w) * p.c * 2,
                                 static_cast<cuuint64_t>(h) * w * p.c * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.vs * 8), static_cast<cuuint32_t>(p.iw),
                             static_cast<cuuint32_t>(p.ih), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tiling of one call: vectors of a slice, then columns and rows split
// evenly into tiles whose input fits a stage.
bool plan(Params& p) {
  const int vectors = p.c / 8;
  p.vs = 1;
  while (p.vs < kMaxVec && vectors % (2 * p.vs) == 0) p.vs *= 2;
  p.lg_vs = 0;
  while ((1 << p.lg_vs) < p.vs) ++p.lg_vs;
  p.slices = vectors / p.vs;
  const int pitch = p.vs * 16;
  p.tiles_x = ceil_div(p.wo, p.stride == 1 ? kColsS1 : kColsS2);
  p.tw = ceil_div(p.wo, p.tiles_x);
  p.iw = (p.tw - 1) * p.stride + 3;
  const int max_ih = kTileBytes / (p.iw * pitch);
  if (max_ih < 3 || p.iw > 256) return false;
  const int max_th = (max_ih - 3) / p.stride + 1;
  p.tiles_y = ceil_div(p.ho, max_th);
  p.th = ceil_div(p.ho, p.tiles_y);
  p.ih = (p.th - 1) * p.stride + 3;
  if (p.ih > 256) return false;
  p.box_bytes = p.ih * p.iw * pitch;
  p.stage_bytes = (p.box_bytes + kStageAlign - 1) / kStageAlign * kStageAlign;
  return true;
}

int sm_count() {
  static int known[stem::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= stem::kMaxDevices) return 0;
  if (known[dev] == 0) cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
  return known[dev];
}

template <int kEpi>
int launch(const void* x, int batch, int h, int w, Params p, cudaStream_t stream) {
  static bool allowed[stem::kMaxDevices] = {};
  static int per_sm[stem::kMaxDevices] = {};
  auto* kernel = depthwise3x3_nhwc<kEpi>;
  const size_t smem = kStageAlign + 2 * static_cast<size_t>(kTileBytes);
  cudaError_t err = stem::smem_opt_in(allowed, kernel, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = dev < stem::kMaxDevices ? per_sm[dev] : 0;
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < stem::kMaxDevices) per_sm[dev] = fit;
  }
  // as many blocks as fit on the card at once, a multiple of the slices
  long long grid = static_cast<long long>(fit) * sm_count() / p.slices * p.slices;
  if (grid < p.slices) grid = p.slices;
  if (grid > p.tiles) grid = p.tiles;
  CUtensorMap map;
  err = input_map(x, batch, h, w, p, &map);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Depthwise 3x3 conv of x (B, H, W, C) with w (C, 1, 3, 3) into out (B, Ho,
// Wo, C), all bf16, at `stride` (1 or 2) with `pad_top` rows and `pad_left`
// columns of zeros before the map. epilogue 0: no bias; 1: `bias` float32,
// added before the one rounding; 2: `bias` bf16, added after the rounding
// and rounded again. C a multiple of 8; x and out 16-byte aligned. Returns
// a cudaError_t; the launch does not synchronise.
extern "C" int depthwise3x3_launch(const void* x, const void* w, const void* bias, void* out,
                                   int batch, int h, int w_in, int c, int ho, int wo, int stride,
                                   int pad_top, int pad_left, int epilogue, void* stream) {
  const uintptr_t misaligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
                               & 15;
  if (batch <= 0 || h <= 0 || w_in <= 0 || c <= 0 || c % 8 != 0 || ho <= 0 || wo <= 0 ||
      (stride != 1 && stride != 2) || pad_top < 0 || pad_left < 0 || epilogue < kRound ||
      epilogue > kBiasBf16 || x == nullptr || w == nullptr || out == nullptr || misaligned ||
      (epilogue != kRound && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.c = c, p.ho = ho, p.wo = wo, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  if (!plan(p)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(batch) * p.tiles_y * p.tiles_x * p.slices;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epilogue == kBiasF32) return launch<kBiasF32>(x, batch, h, w_in, p, st);
  if (epilogue == kBiasBf16) return launch<kBiasBf16>(x, batch, h, w_in, p, st);
  return launch<kRound>(x, batch, h, w_in, p, st);
}
