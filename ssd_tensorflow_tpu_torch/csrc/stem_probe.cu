// Hopper (sm_90a) counterparts of the two stem probe tools' Pallas kernels.
//
// 1. probe_kernel<V> replaces tools/stem_kernel_probe.py's make_call and
//    its bodies k_copy, k_conv11, k_conv11_store, k_taps and
//    k_taps_aligned: the stripped variants that bisect the split stem's
//    cost on the probe's own shapes. Per tile (b, t) of
//    a1 (B, T, 34, WP, 64) bf16, with w1 (64, 128) and w2 (3, 3, 128, 128):
//      copy          out = a1[:16]
//      conv1_1       out = bf16(relu(a1[:16] @ w1))[..., :64]
//      conv1_1_store the same, through a zero-bordered shared-memory tile
//      taps n        y1 = bf16(relu(a1 @ w1)) (34 rows, zero column border),
//                    acc = the first n of the 9 packed 3x3 taps of y1 over
//                    128 channels, relu, max of row pairs, max of the
//                    channel halves: out (B, T, 16, WP, 64)
//      aligned       taps 9 with every tap read at column offset 0: wrong
//                    math on purpose, as in the TPU probe (which reads an
//                    unwritten scratch column there; here that column is
//                    the zero border, so the result is defined).
//    The 128 lanes are the TPU's width packing of two pixels; the port
//    keeps the probe's function, not the packing's purpose.
//    Bound: taps 9 is 2.6 TFLOP at full shape (operations, ~2.6 ms at the
//    bf16 peak); copy and conv1_1 move 1.07 GB (bytes, ~0.32 ms).
//    Design: one 256-thread block per SM walks tiles of 16 conv rows x 16
//    packed columns. It stages the a1 pixels it needs in shared memory,
//    runs conv1_1 as an mma.sync GEMM (K = 64) into an 18 x 18 pixel y1
//    halo of 128 channels, then each tap's 128 x 128 weights (34 KB) are
//    loaded into shared memory in turn and warp w accumulates conv rows
//    2w and 2w+1 x 16 columns x 128 channels (128 f32 registers); the
//    pools run in registers. Nothing is pipelined.
// 2. lane_unflatten_sum_kernel replaces tools/stem_uint8_probe.py's
//    probe_reshape kernel: (R, 6N) bf16 -> (R, N) bf16, each output the
//    float32 sum of its group of 6 in order, rounded once. One thread per
//    output; bound by its 69 KB of bytes, i.e. by launch latency.

#include "stem_common.cuh"

namespace {

using stem::kMaxDevices;
using stem::lds32;
using stem::mma_bf16;

constexpr int kRowsIn = 34;
constexpr int kRowsOut = 16;
constexpr int kCin = 64;
constexpr int kCmid = 128;
constexpr int kColT = 16;      // packed columns per tile
constexpr int kHalo = 18;      // y1 halo rows and columns of a taps tile
constexpr int kThreads = 256;
constexpr int kAStride = 72;   // a1 pixel row in shared memory
constexpr int kCStride = 136;  // y1 pixel row / weight row in shared memory
constexpr size_t kSmemBytes =
    (kHalo * kHalo * kAStride + kHalo * kHalo * kCStride + kCmid * kAStride + kCmid * kCStride) *
    sizeof(__nv_bfloat16);

enum Variant { kCopy = 0, kConv11 = 1, kConv11Store = 2, kTaps = 3, kTapsAligned = 4 };

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const __nv_bfloat16* __restrict__ a1, const __nv_bfloat16* __restrict__ w1t,
             const __nv_bfloat16* __restrict__ w2t, __nv_bfloat16* __restrict__ out, int bts,
             int wp, int n_taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* c1s = as + kHalo * kHalo * kAStride;
  __nv_bfloat16* w1s = c1s + kHalo * kHalo * kCStride;
  __nv_bfloat16* wtap = w1s + kCmid * kAStride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cbs = wp / kColT;
  const int tiles = bts * 2 * cbs;

  if (V != kCopy) {
    // w1t: (128, 64) bf16 [cout][cin]
    for (int i = tid; i < kCmid * 8; i += kThreads)
      reinterpret_cast<uint4*>(w1s + (i >> 3) * kAStride)[i & 7] =
          reinterpret_cast<const uint4*>(w1t + (i >> 3) * kCin)[i & 7];
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bt = tile / (2 * cbs);
    const int rem = tile - bt * 2 * cbs;
    const int half = rem / cbs, x0 = (rem - half * cbs) * kColT;
    const __nv_bfloat16* a = a1 + static_cast<size_t>(bt) * kRowsIn * wp * kCin;
    __nv_bfloat16* o = out + static_cast<size_t>(bt) * kRowsOut * wp * kCin;

    if (V == kCopy) {  // out rows half*8 + [0, 8), columns x0 + [0, 16)
      for (int i = tid; i < 8 * kColT * 8; i += kThreads) {
        const int pix = i >> 3, r = half * 8 + pix / kColT, c = x0 + pix % kColT;
        reinterpret_cast<uint4*>(o + (static_cast<size_t>(r) * wp + c) * kCin)[i & 7] =
            reinterpret_cast<const uint4*>(a + (static_cast<size_t>(r) * wp + c) * kCin)[i & 7];
      }
      continue;
    }

    // a1 pixels of the tile: conv1_1 variants need rows half*8 + [0, 8) x
    // columns x0 + [0, 16); the taps need the y1 halo, rows half*16 +
    // [0, 18) x columns x0 - 1 + [0, 18), zero outside [0, WP).
    constexpr bool kSmall = V == kConv11 || V == kConv11Store;
    constexpr int nr = kSmall ? 8 : kHalo;
    constexpr int nc = kSmall ? kColT : kHalo;
    constexpr int npix = nr * nc;
    const int r0 = kSmall ? half * 8 : half * 16;
    const int c0 = kSmall ? x0 : x0 - 1;
    __syncthreads();  // the previous tile is done with the shared tiles
    for (int i = tid; i < npix * 8; i += kThreads) {
      const int pix = i >> 3, gc = c0 + pix % nc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gc >= 0 && gc < wp)
        v = reinterpret_cast<const uint4*>(
            a + (static_cast<size_t>(r0 + pix / nc) * wp + gc) * kCin)[i & 7];
      reinterpret_cast<uint4*>(as + pix * kAStride)[i & 7] = v;
    }
    __syncthreads();

    // conv1_1: y1[pix][n] = relu(sum_k a1[pix][k] w1[k][n]), K = 64
    constexpr int NT = kSmall ? 8 : 16;  // 8-channel N tiles computed
    for (int mt = warp; mt < (npix + 15) / 16; mt += kThreads / 32) {
      const int p0 = min(mt * 16 + g, npix - 1), p1 = min(mt * 16 + g + 8, npix - 1);
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kCin / 16; ++ks) {
        const __nv_bfloat16* q0 = as + p0 * kAStride + ks * 16 + 2 * t;
        const __nv_bfloat16* q1 = as + p1 * kAStride + ks * 16 + 2 * t;
        const uint32_t af[4] = {lds32(q0), lds32(q1), lds32(q0 + 8), lds32(q1 + 8)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* q = w1s + (nt * 8 + g) * kAStride + ks * 16 + 2 * t;
          mma_bf16(acc[nt], af, lds32(q), lds32(q + 8));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = mt * 16 + g + 8 * i;
        if (p >= npix) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int ch = nt * 8 + 2 * t;
          const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(acc[nt][2 * i], 0.0f),
                                                         fmaxf(acc[nt][2 * i + 1], 0.0f));
          if (V == kConv11)
            *reinterpret_cast<__nv_bfloat162*>(
                o + (static_cast<size_t>(r0 + p / nc) * wp + x0 + p % nc) * kCin + ch) = v;
          else
            *reinterpret_cast<__nv_bfloat162*>(c1s + p * kCStride + ch) = v;
        }
      }
    }
    if (V == kConv11) continue;
    __syncthreads();

    if (V == kConv11Store) {  // the bordered tile's first 64 channels -> out
      for (int i = tid; i < npix * 8; i += kThreads) {
        const int pix = i >> 3;
        reinterpret_cast<uint4*>(
            o + (static_cast<size_t>(r0 + pix / nc) * wp + x0 + pix % nc) * kCin)[i & 7] =
            reinterpret_cast<const uint4*>(c1s + pix * kCStride)[i & 7];
      }
      continue;
    }

    // taps: conv rows half*16 + 2*warp + {0, 1}, columns x0 + [0, 16)
    float acc[2][16][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][nt][k] = 0.0f;
#pragma unroll 1
    for (int tap = 0; tap < n_taps; ++tap) {
      const int dy = tap / 3, dx = V == kTapsAligned ? 0 : tap - (tap / 3) * 3;
      __syncthreads();  // the previous tap's MMAs are done with wtap
      // w2t: (9, 128, 128) bf16 [tap][cout][cin]
      for (int i = tid; i < kCmid * 16; i += kThreads)
        reinterpret_cast<uint4*>(wtap + (i >> 4) * kCStride)[i & 15] =
            reinterpret_cast<const uint4*>(w2t + (static_cast<size_t>(tap) * kCmid + (i >> 4)) * kCmid)[i & 15];
      __syncthreads();
#pragma unroll 2
      for (int ks = 0; ks < kCmid / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* q0 =
              c1s + ((2 * warp + i + dy) * kHalo + g + dx) * kCStride + ks * 16 + 2 * t;
          const __nv_bfloat16* q1 = q0 + 8 * kCStride;
          af[i][0] = lds32(q0);
          af[i][1] = lds32(q1);
          af[i][2] = lds32(q0 + 8);
          af[i][3] = lds32(q1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const __nv_bfloat16* q = wtap + (nt * 8 + g) * kCStride + ks * 16 + 2 * t;
          const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
          mma_bf16(acc[0][nt], af[0], b0, b1);
          mma_bf16(acc[1][nt], af[1], b0, b1);
        }
      }
    }
    // relu, max of the row pair (acc[0], acc[1]) and of the channel halves
    // (N tiles nt and nt + 8); pixel column g holds [0..1], g + 8 [2..3]
    const int prow = half * 8 + warp;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 2 * i + k;
          v[k] = fmaxf(fmaxf(fmaxf(acc[0][nt][e], acc[1][nt][e]),
                             fmaxf(acc[0][nt + 8][e], acc[1][nt + 8][e])),
                       0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            o + (static_cast<size_t>(prow) * wp + x0 + g + 8 * i) * kCin + nt * 8 + 2 * t) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

__global__ void lane_unflatten_sum_kernel(const __nv_bfloat16* __restrict__ x,
                                          __nv_bfloat16* __restrict__ out, int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * n) return;
  const __nv_bfloat16* p = x + static_cast<size_t>(i) * 6;  // row r, group j: r*6n + 6j = 6i
  float s = __bfloat162float(p[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) s = __fadd_rn(s, __bfloat162float(p[k]));
  out[i] = __float2bfloat16_rn(s);
}

bool g_smem_allowed[5][kMaxDevices] = {};

template <int V>
int launch(const void* a1, const void* w1t, const void* w2t, void* out, int bts, int wp,
           int n_taps, int grid, cudaStream_t stream) {
  const size_t smem = V == kCopy ? 0 : kSmemBytes;
  if (smem) {
    const cudaError_t err = stem::smem_opt_in(g_smem_allowed[V], probe_kernel<V>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const __nv_bfloat16*>(w1t),
      static_cast<const __nv_bfloat16*>(w2t), static_cast<__nv_bfloat16*>(out), bts, wp, n_taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 copy, 1 conv1_1, 2 conv1_1_store, 3 taps (n_taps of 9),
// 4 aligned (9 taps). a1: (B*T, 34, WP, 64) bf16; w1t: (128, 64) bf16
// [cout][cin]; w2t: (9, 128, 128) bf16 [dy*3+dxp][cout][cin]; out:
// (B*T, 16, WP, 64) bf16. All contiguous, WP a multiple of 16. `grid`
// persistent blocks. Returns cudaGetLastError() after the launch.
extern "C" int stem_probe_launch(int variant, const void* a1, const void* w1t, const void* w2t,
                                 void* out, int bts, int wp, int n_taps, int grid, void* stream) {
  if (bts <= 0 || wp <= 0 || wp % kColT || grid <= 0 || n_taps < 0 || n_taps > 9)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kCopy: return launch<kCopy>(a1, w1t, w2t, out, bts, wp, n_taps, grid, s);
    case kConv11: return launch<kConv11>(a1, w1t, w2t, out, bts, wp, n_taps, grid, s);
    case kConv11Store: return launch<kConv11Store>(a1, w1t, w2t, out, bts, wp, n_taps, grid, s);
    case kTaps: return launch<kTaps>(a1, w1t, w2t, out, bts, wp, n_taps, grid, s);
    case kTapsAligned: return launch<kTapsAligned>(a1, w1t, w2t, out, bts, wp, 9, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (rows, 6n) bf16 contiguous -> out: (rows, n) bf16.
extern "C" int lane_unflatten_sum_launch(const void* x, void* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int total = rows * n;
  lane_unflatten_sum_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}
